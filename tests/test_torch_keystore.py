"""Rotation-key streaming of the torch port (core/keystore.py, the device
keygen of core/keys.py, CkksContext's budget) against the JAX package.

Tier-1:
  * the port's KeyStore and the JAX KeyStore, driven through the same
    register / get / evict / set sequence under a byte budget, end with
    the same regeneration count, resident bytes and resident set; the
    device keygen on the CPU gives the same key for the same (seed, g)
    and another key for another g, seed or digit; one digit of the key assembly
    (`_ksk_digit`) is bit-equal to the JAX package's `_ksk_kernel_body`
    fed the same uniform `a` and errors (ring 2^8, numpy draws);
  * tests/test_keystore.py's streamed rotation at its ring-2^8 config,
    budget None, 1 MB and 0: every context decrypts within 1e-3 of
    np.roll and of the resident one, and under 1 MB a rotation after
    eviction regenerates its keys and gives the same bits.

`slow`: mehp24 sort_fg under a 2 MB budget in both packages
(tests/test_keystore.py's heavy test), each within the 0.01 gate, the
port's with regenerations past its key count; sort_large_array_fg at
N=512 on both PlainContexts at ring 2^17 with the port bench's degrees,
bit-equal and within the gate (the harness's streamed cell's geometry).

At most two tier-1 tests in this file (see tests/test_torch_serial.py).
"""

import numpy as np
import pytest
import torch

from sorting_fhe_tpu.core import keys as jkeys
from sorting_fhe_tpu.core.keystore import KeyStore as JKeyStore
from sorting_fhe_tpu.core.params import CkksConfig as JCfg
from sorting_fhe_tpu.core.params import CkksParams as JParams
from sorting_fhe_tpu_torch.core import encoding as tenc
from sorting_fhe_tpu_torch.core import keys as tkeys
from sorting_fhe_tpu_torch.core.ckks import CkksContext as TC
from sorting_fhe_tpu_torch.core.keystore import KeyStore as TKeyStore
from sorting_fhe_tpu_torch.core.params import CkksConfig as TCfg
from sorting_fhe_tpu_torch.utils.testvec import vector_with_min_diff

torch.set_num_threads(1)   # one thread per test worker: six share the cores

# tests/test_keystore.py's streaming config
CFG = dict(ring_dim=1 << 8, mult_depth=6, scale_bits=26, comp=1, dnum=2,
           seed=77)


def _store_run(KeyStore, zeros):
    """tests/test_keystore.py's mapping sequence plus an explicit evict;
    `zeros(k)` is a key of 4k bytes."""
    ks = KeyStore(budget_bytes=40, regen=lambda k: zeros(4))
    for k in (1, 2, 3, 4):
        ks.register(k)
    _ = ks[1], ks[2], ks[3]          # 48 bytes: 1 goes
    _ = ks[1], ks[3]                 # 1 again, 2 goes
    ks.evict(3)
    ks[7] = zeros(64)                # pinned
    _ = ks[4], ks[2], ks[1]
    del ks[4]
    return (ks.regen_count, ks.resident_bytes,
            sorted(set(ks._lru) | set(ks._pinned)), sorted(ks), len(ks))


def _a_rows(key):
    """The uniform halves (a_j) of every digit of a key."""
    return key[:, 1]


def test_keystore_keygen_match_jax():
    # the store: the same sequence, the same state in both packages
    want = _store_run(JKeyStore, lambda m: np.zeros(m, dtype=np.uint32))
    got = _store_run(TKeyStore, lambda m: torch.zeros(m, dtype=torch.int32))
    assert got == want
    assert want[0] == 7 and want[1] <= 40 + 256

    # device keygen: deterministic per (seed, g), another g or seed differs
    ctx = TC(TCfg(**CFG), device="cpu")
    kg = ctx.keygen
    g5 = tenc.galois_element_for_rotation(ctx.n, 5)
    g1 = tenc.galois_element_for_rotation(ctx.n, 1)
    k5 = kg.gen_rotation_key_dev(g5)
    assert k5.dtype == torch.int32 and k5.shape == (
        2, 2, len(ctx.params.all_primes), ctx.n)
    assert torch.equal(kg.gen_rotation_key_dev(g5), k5)
    assert not torch.equal(k5[0, 1], k5[1, 1])       # a stream per digit
    assert not torch.equal(_a_rows(kg.gen_rotation_key_dev(g1)),
                           _a_rows(k5))
    other = TC(TCfg(**{**CFG, "seed": 78}), device="cpu")
    assert not torch.equal(_a_rows(other.keygen.gen_rotation_key_dev(g5)),
                           _a_rows(k5))
    p = np.asarray(ctx.params.all_primes, dtype=np.int64)
    assert (k5.long() >= 0).all() and (k5.long() < torch.from_numpy(
        p).reshape(1, 1, -1, 1)).all()

    # one digit of the assembly, bit for bit, on the same draws
    jP = JParams(JCfg(**CFG))
    jkg = jkeys.KeyGenerator(jP)
    assert np.array_equal(jkg.sk.s_coeffs, kg.sk.s_coeffs)
    src, sign = tenc.automorphism_index_table(ctx.n, g5)
    sp = sign * kg.sk.s_coeffs[src]
    rng = np.random.default_rng(3)
    dnum, nrows = 2, len(p)
    a = (rng.integers(0, 1 << 62, size=(dnum, nrows, ctx.n)) %
         p[None, :, None]).astype(np.uint32)
    e = np.rint(rng.normal(0.0, 3.19, size=(dnum, ctx.n))).astype(np.int64)
    w, wsh, rmod, rsh = jkg._ksk_weights()
    red = lambda x: (x % p[:, None]).astype(np.uint32)   # noqa: E731
    want = np.asarray(jkeys._ksk_kernel(
        red(kg.sk.s_coeffs[None, :]), red(sp[None, :]), a,
        (e[:, None, :] % p[None, :, None]).astype(np.uint32), w, wsh, rmod,
        rsh, jP.ntt.p, jP.ntt.psi, jP.ntt.psi_sh, jP.mont_neg_p_inv))
    P = ctx.params
    s_ntt = kg._secret_ntt()
    sp_ntt = tkeys._ntt_mont(torch.from_numpy(sp.astype(np.int64))[None, :]
                             % P.primes_dev[:, None], P)
    tw = kg._ksk_weights()
    got = torch.stack([tkeys._ksk_digit(
        s_ntt, sp_ntt, torch.from_numpy(a[j].astype(np.int64)),
        torch.from_numpy(e[j]), tw[j], P) for j in range(dnum)])
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_streamed_rotation_matches_resident(monkeypatch):
    """tests/test_keystore.py::test_streamed_rotation_matches_resident in
    the port, at budget None (resident), 1 MB (the LRU) and 0 (lazy
    keygen, every key kept), with the environment's budget unset."""
    monkeypatch.delenv("SORTING_FHE_KEY_BUDGET_MB", raising=False)
    N = 8
    v = vector_with_min_diff(N, 0, 1, 1.0 / N, np.random.default_rng(11))
    outs = {}
    for budget in (None, 1, 0):
        ctx = TC(TCfg(**CFG, rot_key_budget_mb=budget), device="cpu")
        ctx.gen_rotation_keys([1, 2, 5])
        assert len(ctx.rot_keys) == 3
        ct = ctx.encrypt(v, slots=N)

        def rot3():
            return ctx.rotate(ctx.rotate(ctx.rotate(ct, 1), 2), 5)
        r = rot3()
        outs[budget] = ctx.decrypt(r)[:N]
        store = ctx.rot_keys
        if budget is None:
            assert store.regen_count == 0 and len(store._pinned) == 3
            continue
        assert store.regen_count == 3
        if budget == 0:                  # made on first use, then pinned
            assert len(store._pinned) == 3 and not store._lru
            continue
        assert len(store._lru) == 3 and store.resident_bytes <= 1 << 20
        for k in (1, 2, 5):
            store.evict(k)
        assert store.resident_bytes == 0
        assert torch.equal(rot3().data, r.data)
        assert store.regen_count == 6 > len(store)
    want = np.roll(v, -8)
    for budget, out in outs.items():
        assert np.abs(out - want).max() < 1e-3, budget
        assert np.abs(out - outs[None]).max() < 1e-3, budget


@pytest.mark.slow
def test_mehp24_sort_under_budget_matches_jax(monkeypatch):
    """tests/test_keystore.py::test_mehp24_sort_under_budget in both
    packages: each within the 0.01 gate, and the port's store makes more
    keys than it holds (the JAX one's device keys are jax.random's, so
    the two ciphertexts differ)."""
    from sorting_fhe_tpu.core.ckks import CkksContext as JC
    from sorting_fhe_tpu.models.mehp24 import sort_fg as jsort_fg
    from sorting_fhe_tpu_torch.models.mehp24 import sort_fg as tsort_fg
    monkeypatch.delenv("SORTING_FHE_KEY_BUDGET_MB", raising=False)
    cfg = dict(ring_dim=1 << 10, mult_depth=34, scale_bits=52, comp=2,
               dnum=4, rot_key_budget_mb=2)
    v = np.array([0.8, 0.3, 0.55, 0.05])
    for ctx, sort_fg in ((JC(JCfg(**cfg)), jsort_fg),
                         (TC(TCfg(**cfg), device="cpu"), tsort_fg)):
        out = sort_fg(ctx, ctx.encrypt(v, slots=16), 4, 2, 2, 1, 2)
        got = ctx.decrypt(out)[:4]
        assert np.abs(got - np.sort(v)).max() < 0.01
    assert ctx.rot_keys.regen_count > len(ctx.rot_keys)


@pytest.mark.slow
def test_sort_large_array_fg_n512_plain_matches_jax():
    """mehp24 N=512 through sort_large_array_fg (two 256-blocks) on both
    PlainContexts at ring 2^17 with bench.mehp24_degrees: the streamed
    chip cell's geometry, its degrees checked against the gate in exact
    arithmetic."""
    from sorting_fhe_tpu.models import mehp24 as JM
    from sorting_fhe_tpu.utils.plain import PlainContext as JPlain
    from sorting_fhe_tpu_torch import registry as treg
    from sorting_fhe_tpu_torch.bench import mehp24_degrees
    from sorting_fhe_tpu_torch.models import mehp24 as TM
    from sorting_fhe_tpu_torch.utils.plain import PlainContext as TPlain
    degrees = mehp24_degrees(treg.get_params("mehp24", 512))
    assert degrees == (4, 2, 5, 2)
    v = vector_with_min_diff(512, 0, 1, 1.0 / 512, np.random.default_rng(7))
    outs = []
    for M, Plain in ((JM, JPlain), (TM, TPlain)):
        ctx = Plain(1 << 17)
        out = M.sort_large_array_fg(ctx, ctx.encrypt(v, slots=256 * 256),
                                    512, 256, *degrees)
        outs.append(ctx.decrypt(out)[:512])
    np.testing.assert_array_equal(outs[1], outs[0])
    assert np.abs(outs[1] - np.sort(v)).max() < 0.01
