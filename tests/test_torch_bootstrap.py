"""EvalBootstrap through the torch port (core/bootstrap.py and the
bootstrap surface of core/ckks.py).

Tier-1:
- op parity with the JAX package on contexts built without keygen
  (`_init_common`, the ring-2^12 config of test_torch_ckks.py), random
  canonical residues standing in for ciphertexts and keys: `rotate_raw`,
  `conjugate` and `mult_monomial` are bit-equal; `mod_raise` is bit-equal
  except at coefficients where the two float32 correction counts round
  differently, and there the coefficients differ by exactly +-D (the
  product of the raised primes) on every row;
- the bootstrap's host-side plan at the chip's ring 2^17 (K and sine
  degree as the JAX package's functions give them, raise point, BSGS
  split, rotation keys) for the slot widths the sorts and the bootstrap
  phase use;
- the port's own Bootstrapper round trip and BootstrapHook dispatch on a
  port-only context at the JAX bootstrap tests' config (ring 2^8, depth
  16, dnum 3, hw 16; tests/test_bootstrap.py), with the same assertions.
  No JAX Bootstrapper is built in tier-1 (its compiles take minutes).

`slow`: the whole bootstrap at ring 2^8 with the JAX package's keys
carried across (`keys_to_torch`), bit-equal when the two mod-raises agree.
"""

from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sorting_fhe_tpu.core import bootstrap as jboot
from sorting_fhe_tpu.core import ckks as jck
from sorting_fhe_tpu.core.params import CkksConfig as JCfg
from sorting_fhe_tpu_torch.core import bootstrap as tboot
from sorting_fhe_tpu_torch.core import ckks as tck
from sorting_fhe_tpu_torch.core import params as tparams
from sorting_fhe_tpu_torch.core.interop import (keys_to_torch,
                                                residues_to_numpy,
                                                residues_to_torch)
from sorting_fhe_tpu_torch.core.ntt import ntt_inv_t
from sorting_fhe_tpu_torch.core.params import CkksConfig as TCfg
from sorting_fhe_tpu_torch.registry import get_params, full_config

torch.set_num_threads(1)   # one thread per test worker: six share the cores

CFG = dict(ring_dim=1 << 12, mult_depth=4, scale_bits=52, comp=2, dnum=2,
           seed=11, limb_pad=1)
BOOT_CFG = dict(ring_dim=1 << 8, mult_depth=16, scale_bits=52, comp=2,
                dnum=3, secret_hw=16)
# coefficients where the float32 counts of mod_raise differ for the seed of
# test_mod_raise_matches_jax_up_to_D (2 x 2^12 lifted coefficients)
MOD_RAISE_MISROUNDS = 0


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


def _cts(j, t, data, slots):
    return (jck.Ciphertext(jnp.asarray(data), 2.0 ** 40, 1, slots),
            tck.Ciphertext(residues_to_torch(data, "cpu"), 2.0 ** 40, 1,
                           slots))


def _eq(jct, tct, what):
    np.testing.assert_array_equal(np.asarray(jct.data),
                                  residues_to_numpy(tct.data), what)


def test_rotate_raw_conjugate_monomial_bit_equal(ctxs):
    j, t = ctxs
    P = t.params
    n, l, slots = P.n, P.alpha + 1, 4     # digits of 6 and 1 rows
    rng = np.random.default_rng(7)
    jc, tc = _cts(j, t, _residues(rng, P.q[:l], (2,), n), slots)
    ksk = _residues(rng, P.all_primes, (P.cfg.dnum, 2), n)
    # a multiple of the slot count: rotate() skips it, rotate_raw() must not
    k = 2 * slots
    j.rot_keys[k] = jnp.asarray(ksk)
    t.rot_keys[k] = residues_to_torch(ksk, "cpu")
    assert t.rotate(tc, k) is tc
    traw = t.rotate_raw(tc, k)
    assert not torch.equal(traw.data, tc.data)
    _eq(j.rotate_raw(jc, k), traw, "rotate_raw")
    assert t.op_counts["rotate_fused"] == 1

    j.conj_key = jnp.asarray(ksk)
    t.conj_key = residues_to_torch(ksk, "cpu")
    _eq(j.conjugate(jc), t.conjugate(tc), "conjugate")
    assert t.op_counts["rotate_fused"] == 2
    for power in (n // 2, 3 * n // 2, 5):
        _eq(j.mult_monomial(jc, power), t.mult_monomial(tc, power),
            f"mult_monomial X^{power}")


def _plain_coeffs(t, data):
    """[k, nq, n] NTT+Mont residues -> plain coefficient residues, int64."""
    P = t.params
    tabs = P.ntt
    x = ntt_inv_t(data, tabs.p[:P.nq], tabs.ipsi[:P.nq],
                  tabs.n_inv[:P.nq]).long()
    return x * P.mont_r_inv[:P.nq].reshape(-1, 1) % \
        P.primes_dev[:P.nq].reshape(-1, 1)


def test_mod_raise_matches_jax_up_to_D(ctxs):
    j, t = ctxs
    P = t.params
    l0, n = P.base_limbs, P.n
    rng = np.random.default_rng(31)
    jc, tc = _cts(j, t, _residues(rng, P.q[:l0], (2,), n), 4)
    jout, tout = j.mod_raise(jc), t.mod_raise(tc)
    assert tout.limbs == P.nq
    a = _plain_coeffs(t, residues_to_torch(np.asarray(jout.data), "cpu"))
    b = _plain_coeffs(t, tout.data)
    p = P.primes_dev[:P.nq].reshape(-1, 1)
    diff = (b - a) % p
    D = P.q_product(l0)
    dmod = torch.tensor([D % q for q in P.q], dtype=torch.int64).reshape(
        -1, 1)
    plus, minus = diff == dmod, diff == (p - dmod) % p
    same = diff == 0
    # per coefficient: every row off by +D, or every row off by -D, or
    # equal (the in-digit rows, where D = 0 mod q, stay equal throughout)
    cols_plus = plus.all(dim=1)
    cols_minus = minus.all(dim=1)
    cols_same = same.all(dim=1)
    assert bool((cols_plus | cols_minus | cols_same).all())
    assert int((~cols_same).sum()) == MOD_RAISE_MISROUNDS
    assert torch.equal(diff[:, :l0], torch.zeros_like(diff[:, :l0]))


@pytest.mark.parametrize("algo,N,slots,sort_keys,keys", [
    ("bitonic", 4, 4, True, 18), ("kway", 16, 16, True, 22),
    ("kway", 16, 128, False, 31)])
def test_bootstrap_plan_matches_jax(algo, N, slots, sort_keys, keys,
                                    monkeypatch):
    """K = 27 and a degree-256 sine for hw 64, as the JAX package's
    default_K and _sine_degree give; the raise point, BSGS split and, with
    the sort's own keys where the sort runs beside it, the rotation keys
    the bench makes (the conjugation key comes on top).  No JAX
    Bootstrapper is built."""
    # the chip's ring-2^17 chain, as far as a Bootstrapper's constructor
    # reads it (n, secret_hw, scale_bits, q_product): no NTT tables
    monkeypatch.setattr(tparams, "NttContext", lambda *a, **kw: None)
    cfg = full_config(get_params(algo, N), secret_hw=64)
    ctx = SimpleNamespace(n=cfg.ring_dim, cfg=cfg,
                          params=tparams.CkksParams(cfg, "cpu"))
    tb = tboot.Bootstrapper(ctx, slots)
    assert tb.K == jboot.default_K(64) == 27
    assert tb._sine_deg == jboot._sine_degree(27) == 256
    assert tb.raise_limbs == 3
    G = 1 << int(np.ceil(np.log2(np.sqrt(slots))))
    assert (tb.G, tb.n_giant) == (G, slots // G)
    half = ctx.n // 2
    network = {j % half for i in range(N.bit_length() - 1)
               for j in (1 << i, -(1 << i))} if sort_keys else set()
    assert len(set(tb.rotation_indices()) | network) == keys


@pytest.fixture(scope="module")
def boot_ctx():
    return tck.CkksContext(TCfg(**BOOT_CFG), device="cpu")


def test_bootstrap_roundtrip(boot_ctx):
    """Exhausted ciphertext -> bootstrap -> same values, many levels back
    (tests/test_bootstrap.py::test_bootstrap_roundtrip's assertions)."""
    ctx = boot_ctx
    bs = tboot.Bootstrapper(ctx, slots=4).setup_keys()
    rng = np.random.default_rng(0)
    v = rng.uniform(-1, 1, 4)
    ct = ctx.level_reduce(ctx.encrypt(v, slots=4), bs.raise_limbs)
    out = bs.bootstrap(ct)
    got = ctx.decrypt(out)[:4]
    assert np.abs(got - v).max() < 1e-3
    assert out.limbs >= bs.raise_limbs + 2 * ctx.params.comp, out.limbs
    assert abs(out.scale / ctx.canonical_scale(out.limbs) - 1) < 0.01
    assert list(bs.phase_s) == list(tboot.PHASES)


def test_bootstrap_hook_dispatch(boot_ctx):
    """BootstrapHook builds one Bootstrapper per slot width, once."""
    hook = tboot.BootstrapHook(boot_ctx)
    v = np.array([0.5, -0.5, 0.25, -0.25])
    out = hook(boot_ctx.level_reduce(boot_ctx.encrypt(v, slots=4), 4))
    assert list(hook._per_slots) == [4]
    first = hook._per_slots[4]
    out2 = hook(boot_ctx.level_reduce(boot_ctx.encrypt(v, slots=4), 4))
    assert list(hook._per_slots) == [4] and hook._per_slots[4] is first
    for o in (out, out2):
        assert np.abs(boot_ctx.decrypt(o)[:4] - v).max() < 1e-3


@pytest.mark.slow
def test_bootstrap_bit_equal_to_jax():
    """The whole bootstrap at ring 2^8 on the JAX package's keys: the same
    ciphertext in, the same bits out when the two mod-raises agree (else
    the outputs decrypt within 1e-3 of each other)."""
    jctx = jck.CkksContext(JCfg(**BOOT_CFG))
    jbs = jboot.Bootstrapper(jctx, slots=4).setup_keys()
    tctx = tck.CkksContext(TCfg(**BOOT_CFG), device="cpu")
    _, tctx.relin_key, rot, tctx.conj_key = keys_to_torch(
        jctx.keygen.public_key, np.asarray(jctx.relin_key),
        {k: np.asarray(jctx.rot_keys[k]) for k in jctx.rot_keys},
        np.asarray(jctx.conj_key), device="cpu")
    for k, key in rot.items():
        tctx.rot_keys[k] = key
    tbs = tboot.Bootstrapper(tctx, slots=4)
    v = np.random.default_rng(0).uniform(-1, 1, 4)
    jct = jctx.level_reduce(jctx.encrypt(v, slots=4), jbs.raise_limbs)
    tct = tck.Ciphertext(residues_to_torch(np.asarray(jct.data), "cpu"),
                         jct.scale, jct.noise_deg, jct.slots)
    raised = []
    for ctx in (jctx, tctx):
        orig = ctx.mod_raise
        ctx.mod_raise = lambda c, _f=orig: raised.append(_f(c)) or raised[-1]
    jout, tout = jbs.bootstrap(jct), tbs.bootstrap(tct)
    agree = np.array_equal(np.asarray(raised[0].data),
                           residues_to_numpy(raised[1].data))
    jv, tv = jctx.decrypt(jout)[:4], tctx.decrypt(tout)[:4]
    assert agree       # this seed: the float32 counts agree everywhere
    np.testing.assert_array_equal(np.asarray(jout.data),
                                  residues_to_numpy(tout.data))
    np.testing.assert_array_equal(jv, tv)
    assert np.abs(tv - v).max() < 1e-3
