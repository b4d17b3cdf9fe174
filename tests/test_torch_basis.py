"""The key switch's base conversions on the CPU: ModUp (`_kj_decompose`),
ModDown (`_k_moddown`) and the mesh's copies of the two (`_extend`,
`_phase3`) go through core/cuda_basis.base_conv, whose plain version must
give the bits of the per-prime loops those functions ran before.

The `old_*` functions below are those loops as they stood, with the
per-digit tables built as they were built; the new code must equal them
bit for bit at ring 2^10 (comp 2, dnum 3: 15 q rows in digits of 5, 5
special rows) at three levels: full digits, a short last digit, one
digit shorter than alpha.  The CUDA kernel against the plain version is
in tests/test_torch_cuda.py.  No JAX here.  Two tier-1 tests only:
`--dist loadfile` queues files by test count (ROADMAP, test time budget).
"""

import numpy as np
import pytest
import torch

from sorting_fhe_tpu_torch.core import ckks as tck
from sorting_fhe_tpu_torch.core import cuda_basis, cuda_lib, nt
from sorting_fhe_tpu_torch.core.params import CkksConfig
from sorting_fhe_tpu_torch.core.rns import sub_mod
from sorting_fhe_tpu_torch.parallel import collective
from sorting_fhe_tpu_torch.parallel.mesh import SlotTables, row_blocks

torch.set_num_threads(1)   # one thread per test worker: six share the cores

I32, I64 = torch.int32, torch.int64
CFG = dict(ring_dim=1 << 10, mult_depth=6, scale_bits=52, comp=2, dnum=3,
           seed=5, limb_pad=1)
LEVELS = (15, 7, 3)
SLOTS = 4


@pytest.fixture(scope="module")
def ctx():
    c = tck.CkksContext.__new__(tck.CkksContext)
    c._init_common(CkksConfig(**CFG), "cpu")
    assert (c.params.nq, c.params.num_special, c.params.alpha) == (15, 5, 5)
    return c


def _residues(rng, primes, lead):
    p = np.asarray(primes, dtype=np.uint64).reshape(-1, 1)
    x = rng.integers(0, 1 << 62, size=lead + (len(primes), 1 << 10),
                     dtype=np.uint64) % p
    return torch.from_numpy(x.astype(np.int64))


def old_digit_tables(P, l):
    """dig_in and dig_conv per digit, as _LevelTables built them."""
    q, R = P.q, 1 << 32
    ext = [q[i] for i in range(l)] + list(P.p_special)
    ins, convs = [], []
    for j in range(-(-l // P.alpha)):
        dig = range(j * P.alpha, min((j + 1) * P.alpha, l))
        D = 1
        for i in dig:
            D *= q[i]
        w_in, Cw = [], np.zeros((len(dig), len(ext)), dtype=np.int64)
        for a, i in enumerate(dig):
            d, dh = q[i], D // q[i]
            w_in.append(nt.mod_inverse(dh % d, d)
                        * nt.mod_inverse(R % d, d) % d)
            for r, pr in enumerate(ext):
                Cw[a, r] = (dh % pr) * (R % pr) % pr
        ins.append(torch.tensor(w_in, dtype=I64))
        convs.append(torch.from_numpy(Cw))
    return ins, convs


def old_decompose(cx, T, dig_in, dig_conv):
    l, n = cx.shape
    cc = tck._inv_q(cx, T, 0, l).to(I64)
    pe = T.ext_p.reshape(-1, 1)
    out = torch.empty((T.ndig, l + T.ksp, n), dtype=I32)
    for j, dig in enumerate(T.digits):
        lo, hi = dig[0], dig[-1] + 1
        x = cc[lo:hi]
        xhat = x * dig_in[j].reshape(-1, 1) % T.q_p[lo:hi].reshape(-1, 1)
        acc = torch.zeros((l + T.ksp, n), dtype=I64)
        for a in range(hi - lo):
            acc += xhat[a] * dig_conv[j][a].reshape(-1, 1) % pe
        acc %= pe
        acc[lo:hi] = x
        out[j] = acc
    return tck._fwd_ext(out, T)


def old_moddown(acc, T):
    l = T.l
    k, _, n = acc.shape
    spc = tck._inv_sp(acc[:, l:, :], T).to(I64)
    xhat = spc * tck._col(T.md_in) % tck._col(T.sp_p)
    qp = tck._col(T.q_p)
    conv = torch.zeros((k, l, n), dtype=I64)
    for a in range(spc.shape[1]):
        conv += xhat[:, a:a + 1, :] * tck._col(T.md_conv[a]) % qp
    conv %= qp
    convn = tck._fwd_q(conv, T, l)
    return sub_mod(acc[:, :l, :], convn, qp) * tck._col(T.md_pinv) % qp


def old_extend(cc, xhat, S, spans):
    lq, n = cc.shape
    pe = S.ext_p.reshape(-1, 1)
    xh = xhat.to(I64)
    ext = torch.empty((len(spans), pe.shape[0], n), dtype=I32)
    for j, (lo, hi) in enumerate(spans):
        acc = torch.zeros((pe.shape[0], n), dtype=I64)
        for a in range(lo, hi):
            acc += xh[a] * S.dig_conv[a].reshape(-1, 1) % pe
        acc %= pe
        acc[:lq] = torch.where(S.in_digit[j], cc.to(I64), acc[:lq])
        ext[j] = acc
    return collective.fwd(ext, S, S.rows_ext)


def old_phase3(acc_q, xs, S):
    if not S.lq:
        return acc_q
    qp = tck._col(S.q_p)
    xs = xs.to(I64)
    conv = torch.zeros_like(acc_q)
    for a in range(xs.shape[1]):
        conv += xs[:, a:a + 1] * tck._col(S.md_conv[a]) % qp
    conv %= qp
    convn = collective.fwd(conv, S, S.rows_q)
    return sub_mod(acc_q, convn, qp) * tck._col(S.md_pinv) % qp


def test_modup_moddown_equal_the_old_loops(ctx):
    """_kj_decompose and _k_moddown against the old loops at each level,
    the tables against the old per-digit ones; the wrapper launches and
    builds nothing on the CPU and raises on what the kernel does not
    take."""
    P, rng = ctx.params, np.random.default_rng(10)
    before = cuda_lib.launches["base_conv"]
    lib = cuda_lib._lib         # None unless a card's test loaded it first
    for l in LEVELS:
        T = ctx.tables(l)
        ins, convs = old_digit_tables(P, l)
        assert torch.equal(torch.cat(ins), T.dig_in)
        assert torch.equal(torch.cat(convs), T.dig_conv)
        cx = _residues(rng, P.q[:l], ()).to(I32)
        got = tck._kj_decompose(cx, T)
        assert got.dtype == I32
        assert torch.equal(got, old_decompose(cx, T, ins, convs)), l
        acc = _residues(rng, P.q[:l] + list(P.p_special), (2,))
        got = tck._k_moddown(acc[:, :l].to(I32).contiguous(),
                             acc[:, l:].to(I32).contiguous(), T)
        assert got.dtype == I32
        assert torch.equal(got, old_moddown(acc, T).to(I32)), l
    assert cuda_lib.launches["base_conv"] == before
    assert cuda_lib._lib is lib         # nothing was built or loaded
    T = ctx.tables(LEVELS[0])
    x = _residues(rng, P.q[:15], (1,)).to(I32)
    args = (T.dig_conv, T.ext_p, T.alpha, T.dig_in, T.q_p)
    with pytest.raises(TypeError):
        cuda_basis.base_conv(x.long(), *args)
    with pytest.raises(ValueError):
        cuda_basis.base_conv(x.transpose(1, 2).contiguous()
                             .transpose(1, 2), *args)
    with pytest.raises(ValueError):     # conv's rows must match x's
        cuda_basis.base_conv(x[:, :14].contiguous(), *args)
    with pytest.raises(ValueError):     # the pre-scale comes whole
        cuda_basis.base_conv(x, *args[:4])
    with pytest.raises(ValueError, match="keep_own"):   # 15 rows onto 5
        cuda_basis.base_conv(x, torch.zeros((15, 5), dtype=I64), T.sp_p,
                             5, keep_own=True)


def test_mesh_extend_phase3_equal_the_old_loops(ctx):
    """The mesh's _extend and _phase3, per slot of a 4-slot CPU mesh (15
    q rows in blocks of 4/4/4/3, 5 special rows in 2/2/1/0), against the
    old loops at each level, where slots run out of q rows (level 3: two
    slots with none, one with no rows at all)."""
    P, rng = ctx.params, np.random.default_rng(11)
    cpu = torch.device("cpu")
    q_blocks = row_blocks(P.nq, SLOTS)
    sp_blocks = row_blocks(P.num_special, SLOTS)
    for l in LEVELS:
        T = ctx.tables(l)
        spans = [(d[0], d[-1] + 1) for d in T.digits]
        slots = [SlotTables(P, T, torch.arange(lo, max(lo, min(hi, l))),
                            torch.arange(slo, shi), hi - lo, cpu, P.ntt)
                 for (lo, hi), (slo, shi) in zip(q_blocks, sp_blocks)]
        c1 = _residues(rng, P.q[:l], ()).to(I32)
        p1 = [collective._phase1(c1[S.rows_q.long()], S) for S in slots]
        xhat = torch.cat([x for _, x in p1])          # the digit gather
        xs = _residues(rng, list(P.p_special), (2,)).to(I32)
        for (cc, _), S in zip(p1, slots):
            got = collective._extend(cc, xhat, S)
            assert torch.equal(got, old_extend(cc, xhat, S, spans)), l
            acc_q = _residues(rng, S.q_host, (2,))
            assert torch.equal(collective._phase3(acc_q.to(I32), xs, S),
                               old_phase3(acc_q, xs, S).to(I32)), l
