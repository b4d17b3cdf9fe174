"""The key switch's second half on the CPU: the key inner product and
ModDown's tail go through core/cuda_keyswitch (`ks_inner`,
`moddown_tail`), whose plain versions must give the bits of the int64
chains the key switch ran before, on one device and on a mesh.

The `old_*` functions below are those chains as they stood
(`_k_ks_inner`, `_k_moddown` and `CkksContext._keyswitch` with its
`index_select` of the digits; `_inner` and `_phase3` of
parallel/collective.py); the new code must equal them bit for bit at ring
2^10 on chains of 15 q rows cut at dnum 3, 4 and 8 (digits of 5, 4 and
2 rows), at the top level, at a level whose last digit is short and at
a level of one digit, for relinearisation, a rotation and conjugation.
The keys are random residues: the arithmetic does not depend on their
origin.  The CUDA kernels against the plain versions are in
tests/test_torch_cuda.py.  No JAX here.  Two tier-1 tests only:
`--dist loadfile` queues files by test count (ROADMAP, test time budget).
"""

import numpy as np
import pytest
import torch

from sorting_fhe_tpu_torch.core import ckks as tck
from sorting_fhe_tpu_torch.core import cuda_keyswitch, cuda_lib
from sorting_fhe_tpu_torch.core.params import CkksConfig
from sorting_fhe_tpu_torch.core.rns import sub_mod
from sorting_fhe_tpu_torch.parallel import collective
from sorting_fhe_tpu_torch.parallel.mesh import (make_mesh,
                                                 shard_context_tables)

torch.set_num_threads(1)   # one thread per test worker: six share the cores

I32, I64 = torch.int32, torch.int64
CPU = torch.device("cpu")
N = 1 << 10
ROT = 3
# dnum -> (levels): top, a short last digit, one digit
DNUMS = {3: (15, 12, 4), 4: (15, 9, 3), 8: (15, 7, 2)}
TAGS = ("relin", ROT, "conj")
SLOTS = 8


def _ctx(dnum):
    """A ring-2^10 context of 15 q rows at `dnum`, its keys random
    residues of the chain's primes."""
    c = tck.CkksContext.__new__(tck.CkksContext)
    c._init_common(CkksConfig(ring_dim=N, mult_depth=6, scale_bits=52,
                              comp=2, dnum=dnum, seed=5), "cpu")
    P = c.params
    assert (P.nq, P.alpha) == (15, -(-15 // dnum))
    rng = np.random.default_rng(dnum)
    c.relin_key = _residues(rng, P.all_primes, (dnum, 2))
    c.conj_key = _residues(rng, P.all_primes, (dnum, 2))
    c.rot_keys[ROT] = _residues(rng, P.all_primes, (dnum, 2))
    return c


def _residues(rng, primes, lead):
    p = np.asarray(primes, dtype=np.uint64).reshape(-1, 1)
    x = rng.integers(0, 1 << 62, size=lead + (len(primes), N),
                     dtype=np.uint64) % p
    return torch.from_numpy(x.astype(np.int32))


def _exts(ctx, l, rng):
    T = ctx.tables(l)
    return _residues(rng, T.q_host + list(ctx.params.p_special), (T.ndig,))


def old_ks_inner(exts, ksk, T):
    l, nq, ksp = T.l, T.nq, T.ksp
    pe = tck._col(T.ext_p)
    acc = None
    for j in range(exts.shape[0]):
        key = torch.cat([ksk[j, :, :l], ksk[j, :, nq:nq + ksp]], dim=1)
        term = exts[j][None].to(I64) * key
        term %= pe
        acc = term if acc is None else acc.add_(term)
    acc %= pe
    acc *= tck._col(T.ext_rinv)
    acc %= pe
    return acc


def old_moddown(acc, T):
    l = T.l
    conv = tck._inv_sp(acc[:, l:, :], T)
    conv = tck.base_conv(conv, T.md_conv, T.q_p, T.ksp, T.md_in,
                         T.sp_p)[:, 0]
    conv = tck._fwd_q(conv, T, l)
    qp = tck._col(T.q_p)
    diff = sub_mod(acc[:, :l, :], conv, qp)
    diff *= tck._col(T.md_pinv)
    diff %= qp
    return diff


def old_keyswitch(ctx, exts, tag, l):
    T = ctx.tables(l)
    if tag != "relin":
        exts = exts.index_select(-1, ctx._perm(tag))
    return old_moddown(old_ks_inner(exts, ctx._key(tag), T), T)


def old_inner(ext, key, perm, S):
    if perm is not None:
        ext = ext.index_select(-1, perm)
    pe = tck._col(S.ext_p)
    acc = None
    for j in range(ext.shape[0]):
        term = ext[j][None].to(I64) * key[j] % pe
        acc = term if acc is None else acc.add_(term)
    acc = acc % pe * tck._col(S.ext_rinv) % pe
    spc = collective.inv(acc[:, S.lq:], S, S.rows_sp).to(I64)
    xs = spc * tck._col(S.md_in) % tck._col(S.sp_p)
    return acc[:, :S.lq], xs.to(I32)


def old_phase3(acc_q, xs, S):
    if not S.lq:
        return acc_q
    qp = tck._col(S.q_p)
    conv = tck.base_conv(xs, S.md_conv, S.q_p, xs.shape[1])[:, 0]
    convn = collective.fwd(conv, S, S.rows_q)
    return sub_mod(acc_q, convn, qp) * tck._col(S.md_pinv) % qp


def old_key_rows(S, block):
    if S.lq == S.bq:
        return block
    return torch.cat([block[:, :, :S.lq], block[:, :, S.bq:]], dim=2)


def test_ks_inner_moddown_tail_equal_the_old_chains():
    """ks_inner and moddown_tail, alone and through _keyswitch, against
    the old chains at each dnum, level and key; on the CPU nothing is
    built or launched, and the wrappers raise on what the kernels do not
    take."""
    lib = cuda_lib._lib         # None unless a card's test loaded it first
    before = cuda_lib.launches.copy()
    for dnum, levels in DNUMS.items():
        ctx = _ctx(dnum)
        rng = np.random.default_rng(10 + dnum)
        for l in levels:
            T = ctx.tables(l)
            assert l <= T.alpha or l % T.alpha or l == ctx.params.nq
            exts = _exts(ctx, l, rng)
            for tag in TAGS:
                perm = None if tag == "relin" else ctx._perm(tag)
                key = ctx._key(tag)
                want = old_ks_inner(exts if perm is None else
                                    exts.index_select(-1, perm), key, T)
                q, sp = cuda_keyswitch.ks_inner(exts, key, T.ext_p,
                                                T.ext_rinv, l, T.nq, perm)
                assert q.dtype == sp.dtype == I32
                assert q.is_contiguous() and sp.is_contiguous()
                assert torch.equal(torch.cat([q, sp], dim=1),
                                   want.to(I32)), (dnum, l, tag)
                conv = _residues(rng, T.q_host, (2,))
                assert torch.equal(
                    cuda_keyswitch.moddown_tail(q, conv, T.q_p, T.md_pinv),
                    (sub_mod(q, conv, tck._col(T.q_p))
                     * tck._col(T.md_pinv) % tck._col(T.q_p)).to(I32))
                got = ctx._keyswitch(exts, tag, l)
                assert got.dtype == I32
                assert torch.equal(got, old_keyswitch(ctx, exts, tag,
                                                      l).to(I32)), \
                    (dnum, l, tag)
    assert cuda_lib.launches == before
    assert cuda_lib._lib is lib         # nothing was built or loaded

    T = ctx.tables(15)
    exts, key = _exts(ctx, 15, rng), ctx._key("relin")
    args = (T.ext_p, T.ext_rinv, 15, T.nq)
    with pytest.raises(TypeError):
        cuda_keyswitch.ks_inner(exts.long(), key, *args)
    with pytest.raises(ValueError):
        cuda_keyswitch.ks_inner(exts.transpose(1, 2).contiguous()
                                .transpose(1, 2), key, *args)
    with pytest.raises(ValueError):     # fewer key digits than digits
        cuda_keyswitch.ks_inner(exts, key[:1].contiguous(), *args)
    with pytest.raises(ValueError):     # special rows past the key's
        cuda_keyswitch.ks_inner(exts, key, T.ext_p, T.ext_rinv, 15, 16)
    with pytest.raises(ValueError):     # a permutation of int32
        cuda_keyswitch.ks_inner(exts, key, *args,
                                ctx._perm(ROT).to(I32))
    q = _residues(rng, T.q_host, (2,))
    with pytest.raises(TypeError):
        cuda_keyswitch.moddown_tail(q.long(), q, T.q_p, T.md_pinv)
    with pytest.raises(ValueError):
        cuda_keyswitch.moddown_tail(q, q[:, :14].contiguous(), T.q_p,
                                    T.md_pinv)
    with pytest.raises(ValueError):     # the tables of another level
        cuda_keyswitch.moddown_tail(q, q, T.q_p[:14].contiguous(),
                                    T.md_pinv)


def test_mesh_inner_phase3_equal_one_device():
    """The mesh's key switch (collective.keyswitch: _inner, the ModDown
    gather, _phase3) on 8 CPU slots (15 q rows in blocks of 2 and one of
    1, 4 special rows on the first four slots), for each key and level
    of dnum 4: torch.equal to the single-device _keyswitch once gathered,
    and _inner and _phase3 per slot to the old chains."""
    ctx = _ctx(4)
    mesh = make_mesh(devices=[CPU] * SLOTS)
    shard_context_tables(ctx, mesh)
    nq = ctx.params.nq
    rng = np.random.default_rng(20)
    for l in DNUMS[4]:
        slots = ctx.mesh_tables.level(l)
        exts = _exts(ctx, l, rng)
        ext_blocks = [torch.cat([exts[:, S.rows_q.long()],
                                 exts[:, l - nq + S.rows_sp.long()]], dim=1)
                      for S in slots]
        for tag in TAGS:
            keys = ctx.mesh_tables.blocks(tag)
            perms = [None if tag == "relin" else ctx._perm(tag, S.device)
                     for S in slots]
            got = collective.keyswitch(ext_blocks, keys, perms, slots, mesh)
            assert all(b.dtype == I32 for b in got)
            assert torch.equal(torch.cat(list(got), dim=1),
                               ctx._keyswitch(exts, tag, l)), (l, tag)
            p2 = [collective._inner(e, k, pm, S)
                  for e, k, pm, S in zip(ext_blocks, keys, perms, slots)]
            xs = torch.cat([x for _, x in p2], dim=1)   # the ModDown gather
            for (acc_q, x), e, k, pm, S in zip(p2, ext_blocks, keys, perms,
                                               slots):
                old_q, old_x = old_inner(e, old_key_rows(S, k), pm, S)
                assert torch.equal(acc_q, old_q.to(I32)), (l, tag)
                assert torch.equal(x, old_x), (l, tag)
                assert torch.equal(collective._phase3(acc_q, xs, S),
                                   old_phase3(old_q, xs, S).to(I32))
