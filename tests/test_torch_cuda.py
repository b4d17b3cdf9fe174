"""K1/K2, the base-conversion kernel, the key switch's two kernels and the
composite rescale's lift against their plain versions, on the card, each
call counted once in core/cuda_lib.py's `launches`.

Marked `cuda`: they skip without a CUDA device (a CUDA kernel has no CPU
mode).  This file imports no JAX, so it also runs where only the port is
installed:

    python -m pytest -o addopts="" --noconftest -p no:cacheprovider \
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from sorting_fhe_tpu_torch.core import (cuda_basis, cuda_lib, cuda_ntt,
                                        nt)
from sorting_fhe_tpu_torch.core.ntt import NttContext, ntt_fwd_t, ntt_inv_t

torch.set_num_threads(1)   # one thread per test worker: six share the cores

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda:0")


@pytest.mark.parametrize("logn", [8, 11, 12, 14, 17, 18])
def test_kernels_bit_equal_to_plain(device, logn):
    """Prefix rows, row subset [4, 1, 5] with a leading dim, a single
    dynamic row; n = 2^8 and 2^11 run the chunk pass alone, 2^12, 2^14,
    2^17 and 2^18 add a column pass of 1, 3, 6 and 7 stages at the 2^11
    chunk (calls too small to fill the card take the 2^10 chunk and one
    column stage more)."""
    n = 1 << logn
    primes = nt.find_ntt_primes(28, 6, n)
    tabs = NttContext(primes, n, device)
    rng = np.random.default_rng(logn)
    for sel, lead in ((list(range(6)), ()), ([4, 1, 5], (2,)), ([3], (2,))):
        p = np.asarray([primes[i] for i in sel], np.uint64).reshape(-1, 1)
        x = (rng.integers(0, 1 << 62, size=lead + (len(sel), n),
                          dtype=np.uint64) % p).astype(np.uint32)
        x = torch.from_numpy(x.view(np.int32)).to(device)
        rows = torch.tensor(sel, dtype=torch.int32, device=device)
        r = rows.long()
        before = cuda_lib.launches["ntt_fwd"]
        f = cuda_ntt.ntt_fwd(x, tabs, rows)
        assert cuda_lib.launches["ntt_fwd"] == before + 1
        assert torch.equal(f, ntt_fwd_t(x, tabs.p[r], tabs.psi[r]))
        i = cuda_ntt.ntt_inv(f, tabs, rows)
        assert torch.equal(i, ntt_inv_t(f, tabs.p[r], tabs.ipsi[r],
                                        tabs.n_inv[r]))
        assert torch.equal(i, x)


def test_kernels_at_ring18_chain(device):
    """The ring-2^18 tier's largest class, [3, 154, 2^18]: the top-level
    decompose of hybrid1 N=1024 (115 q + 39 special primes, dnum 3) on
    its registry chain's rows, bit-equal to the plain versions."""
    from sorting_fhe_tpu_torch.core.params import CkksParams
    from sorting_fhe_tpu_torch.registry import full_config, get_params
    P = CkksParams(full_config(get_params("hybrid1", 1024)), device)
    tabs, n, L = P.ntt, P.n, len(P.all_primes)
    assert (n, L, -(-P.nq // P.alpha)) == (1 << 18, 154, 3)
    p = np.asarray(P.all_primes, np.uint64).reshape(-1, 1)
    x = (np.random.default_rng(18).integers(0, 1 << 62, size=(3, L, n),
                                            dtype=np.uint64) % p)
    x = torch.from_numpy(x.astype(np.uint32).view(np.int32)).to(device)
    rows = torch.arange(L, dtype=torch.int32, device=device)
    f = cuda_ntt.ntt_fwd(x, tabs, rows)
    assert torch.equal(f, ntt_fwd_t(x, tabs.p, tabs.psi))
    i = cuda_ntt.ntt_inv(f, tabs, rows)
    assert torch.equal(i, ntt_inv_t(f, tabs.p, tabs.ipsi, tabs.n_inv))
    assert torch.equal(i, x)


def test_launch_plan_covers_every_stage(device):
    """The library's plan for every ring the kernels take, at the limb
    counts of the main path's calls (rescale [2, 1, n], special primes
    [2, 24, n], decompose inverse [95, n], moddown/rescale forward
    [2, 95, n], decompose forward [4, 119, n]) and a single limb."""
    for logn in range(1, cuda_ntt.MAX_LOGN + 1):
        for limbs in (1, 2, 48, 95, 190, 476):
            pl = cuda_ntt.launch_plan(limbs, logn)
            logc, logw = pl["logc"], pl["logw"]
            logr = logn - logc
            # every stage once: log2(R) column stages + logc chunk stages
            assert logc == min(logn, 11) or (logc == 10 and logn > 11)
            assert pl["chunk_blocks"] << logc == limbs << logn
            if logr:
                assert 3 <= logw <= 6 and logw <= logc
                assert pl["col_blocks"] << logw == limbs << logc
                assert pl["col_smem"] >= 4 << (logr + logw)
            else:
                assert pl["col_blocks"] == 0 and logw == 0
            assert pl["chunk_smem"] >= 4 << logc
            # within the 48 KB a block takes without opting in
            assert max(pl["col_smem"], pl["chunk_smem"]) <= 48 * 1024
            # >= 132 blocks (one per H100 SM) wherever the shape has them
            if logn > 11 and limbs << (logn - 10) >= 132:
                assert pl["chunk_blocks"] >= 132
            if logr and limbs << 7 >= 132:
                assert pl["col_blocks"] >= 132


def test_kernel_rejects_bad_input(device):
    n = 1 << 8
    tabs = NttContext(nt.find_ntt_primes(28, 2, n), n, device)
    rows = torch.arange(2, dtype=torch.int32, device=device)
    with pytest.raises(ValueError):
        cuda_ntt.ntt_fwd(torch.zeros((2, n), dtype=torch.int32), tabs, rows)
    with pytest.raises(ValueError):
        cuda_ntt.ntt_fwd(torch.zeros((3, n), dtype=torch.int32,
                                     device=device), tabs, rows)
    n = 1 << 19                     # above the kernels' ring 2^18
    big = NttContext(nt.find_ntt_primes(28, 2, n), n, device)
    for fn in (cuda_ntt.ntt_fwd, cuda_ntt.ntt_inv):
        with pytest.raises(ValueError, match="2\\^18"):
            fn(torch.zeros((2, n), dtype=torch.int32, device=device), big,
               rows)


# (K, source rows L, digit width, target rows R, logn): the classes of the
# key switch's base conversions.  ModUp: one poly, every digit onto the
# level's q + special rows; ModDown: both polys, the special rows onto the
# q rows.  hybrid1 N=128 (95 q + 24 special, digits of 24) at its top
# level and at l = 3; MEHP24 N=128 (89 + 30, digits of 30); the ring-2^18
# chain (115 + 39, digits of 39).
BASIS_CLASSES = {
    "hybrid1 modup l=95": (1, 95, 24, 119, 17),
    "hybrid1 moddown l=95": (2, 24, 24, 95, 17),
    "hybrid1 modup l=3": (1, 3, 24, 27, 17),
    "hybrid1 moddown l=3": (2, 24, 24, 3, 17),
    "mehp24 modup l=89": (1, 89, 30, 119, 17),
    "mehp24 moddown l=89": (2, 30, 30, 89, 17),
    "ring18 modup l=115": (1, 115, 39, 154, 18),
    "ring18 moddown l=115": (2, 39, 39, 115, 18),
}


def _basis_case(device, K, L, R, n, top, rng):
    """Inputs of a conversion from L source primes onto R target primes
    (30-bit primes; the kernel needs no NTT-friendly ones, and ring 2^18
    has too few of 30 bits for 269): random canonical residues, or every
    residue and constant at p - 1 (`top`), the largest sums the
    accumulator meets."""
    primes = nt.find_ntt_primes(30, L + R, 1 << 12)
    q = torch.tensor(primes[:L], dtype=torch.int64, device=device)
    p = torch.tensor(primes[L:], dtype=torch.int64, device=device)
    if top:
        x = (q - 1).reshape(1, -1, 1).expand(K, L, n)
        return (x.to(torch.int32).contiguous(),
                (p - 1).expand(L, R).contiguous(), p, q - 1, q)

    def draw(shape, mod):
        v = rng.integers(0, 1 << 62, size=shape, dtype=np.uint64)
        return torch.from_numpy((v % mod).astype(np.int64)).to(device)
    qs = np.asarray(primes[:L], np.uint64)
    x = draw((K, L, n), qs.reshape(-1, 1)).to(torch.int32)
    conv = draw((L, R), np.asarray(primes[L:], np.uint64))
    return x, conv, p, draw((L,), qs), q


@pytest.mark.parametrize("name", list(BASIS_CLASSES))
def test_base_conv_bit_equal_to_plain(device, name):
    """The kernel at each class, with the pre-scale (ModUp, ModDown) and
    without (the mesh, whose slots pre-scale before the gather), and on
    ModUp's classes with and without keep_own, on random residues and on
    residues and constants at p - 1: bit-equal to base_conv_t, one launch
    a call."""
    K, L, alpha, R, logn = BASIS_CLASSES[name]
    rng = np.random.default_rng(L * R)
    for top in (False, True):
        x, conv, p, w, q = _basis_case(device, K, L, R, 1 << logn, top, rng)
        for pre in ((w, q), (None, None)):
            for keep in (False, True) if R >= L else (False,):
                before = cuda_lib.launches["base_conv"]
                got = cuda_basis.base_conv(x, conv, p, alpha, *pre,
                                           keep_own=keep)
                assert cuda_lib.launches["base_conv"] == before + 1
                want = cuda_basis.base_conv_t(x, conv, p, alpha, *pre,
                                              keep_own=keep)
                assert got.shape == (K, -(-L // alpha), R, 1 << logn)
                assert torch.equal(got, want), (name, top, pre[0] is None,
                                                keep)


def test_base_conv_rejects_bad_input(device):
    rng = np.random.default_rng(3)
    x, conv, p, w, q = _basis_case(device, 2, 24, 5, 1 << 8, False, rng)
    with pytest.raises(TypeError):              # int64 residues
        cuda_basis.base_conv(x.long(), conv, p, 24, w, q)
    with pytest.raises(ValueError):             # not contiguous
        cuda_basis.base_conv(x.transpose(0, 1).contiguous().transpose(0, 1),
                             conv, p, 24, w, q)
    with pytest.raises(ValueError):             # a CPU tensor among CUDA ones
        cuda_basis.base_conv(x.cpu(), conv, p, 24, w, q)
    with pytest.raises(ValueError):
        cuda_basis.base_conv(x, conv.cpu(), p, 24, w, q)
    with pytest.raises(ValueError, match="keep_own"):   # R < L
        cuda_basis.base_conv(x, conv, p, 24, w, q, keep_own=True)
    x, conv, p, w, q = _basis_case(device, 1, 41, 3, 1 << 8, False, rng)
    with pytest.raises(ValueError, match="40"):  # above the register plan
        cuda_basis.base_conv(x, conv, p, 41, w, q)


# (digits, q rows lq, special rows, key's q rows kq, logn): the key
# switch's second half (core/cuda_keyswitch.py) at the top level of each
# benchmark cell's chain (hybrid1 N=128: 95 q + 24 special, 4 digits;
# MEHP24 N=128: 89 + 30, 3 digits; MEHP24 N=512: 105 + 14, 8 digits) and
# at a level of one digit (hybrid1 at l = 20, the key's rows read from
# past the level's)
KS_CLASSES = {
    "hybrid1 l=95": (4, 95, 24, 95, 17),
    "mehp24 l=89": (3, 89, 30, 89, 17),
    "mehp24 N=512 l=105": (8, 105, 14, 105, 17),
    "hybrid1 l=20": (1, 20, 24, 95, 17),
}


def _ks_case(device, ndig, lq, ks, kq, n, top, rng):
    """Digits, key (one digit more than used, the rows a level leaves out
    at 0), ext primes, 2^-32 mod each, and for the tail P^-1 stand-ins:
    random canonical residues, or every residue at p - 1 (`top`)."""
    I64 = torch.int64
    E = lq + ks
    primes = nt.find_ntt_primes(30, E, 1 << 12)
    p = torch.tensor(primes, dtype=I64, device=device)
    rinv = torch.tensor([nt.mod_inverse((1 << 32) % q, q) for q in primes],
                        dtype=I64, device=device)
    rows = [primes[r] if r < lq else 0 for r in range(kq)] + primes[lq:]
    pk = np.asarray([r or 1 for r in rows], np.uint64).reshape(-1, 1)

    def draw(shape, mod):
        if top:
            v = np.broadcast_to(mod - 1, shape)
        else:
            v = rng.integers(0, 1 << 62, size=shape, dtype=np.uint64) % mod
        v = np.ascontiguousarray(v, dtype=np.uint32).view(np.int32)
        return torch.from_numpy(v).to(device)
    pe = np.asarray(primes, np.uint64).reshape(-1, 1)
    exts = draw((ndig, E, n), pe)
    key = draw((ndig + 1, 2, kq + ks, n), pk)
    return exts, key, p, rinv


@pytest.mark.parametrize("name", list(KS_CLASSES))
def test_ks_inner_moddown_tail_bit_equal_to_plain(device, name):
    """ks_inner for relinearisation (no permutation), a rotation, the
    conjugation and a random permutation (which splits the aligned groups
    of four columns: the kernel's scalar path), on random residues and on
    residues at p - 1; moddown_tail on its q rows: each bit-equal to its
    plain version, one launch a call."""
    from sorting_fhe_tpu_torch.core import cuda_keyswitch as ck
    from sorting_fhe_tpu_torch.core import encoding
    ndig, lq, ks, kq, logn = KS_CLASSES[name]
    n = 1 << logn
    rng = np.random.default_rng(lq * ndig)
    perms = [None] + [torch.from_numpy(p.astype(np.int64)).to(device)
                      for p in (
        encoding.automorphism_eval_perm(
            n, encoding.galois_element_for_rotation(n, 3)),
        encoding.automorphism_eval_perm(n, 2 * n - 1),
        rng.permutation(n))]
    for top in (False, True):
        exts, key, p, rinv = _ks_case(device, ndig, lq, ks, kq, n, top, rng)
        for i, perm in enumerate(perms):
            before = cuda_lib.launches["ks_inner"]
            q, sp = ck.ks_inner(exts, key, p, rinv, lq, kq, perm)
            assert cuda_lib.launches["ks_inner"] == before + 1
            wq, wsp = ck.ks_inner_t(exts, key, p, rinv, lq, kq, perm)
            assert torch.equal(q, wq) and torch.equal(sp, wsp), (top, i)
        conv = exts[0, :lq].expand(2, lq, n).contiguous()
        pinv = rinv[:lq].contiguous()
        before = cuda_lib.launches["moddown_tail"]
        got = ck.moddown_tail(q, conv, p[:lq].contiguous(), pinv)
        assert cuda_lib.launches["moddown_tail"] == before + 1
        assert torch.equal(got, ck.moddown_tail_t(q, conv, p[:lq], pinv))


def test_ks_inner_rejects_bad_input(device):
    from sorting_fhe_tpu_torch.core import cuda_keyswitch as ck
    rng = np.random.default_rng(4)
    exts, key, p, rinv = _ks_case(device, 2, 6, 2, 6, 1 << 8, False, rng)
    with pytest.raises(TypeError):              # int64 residues
        ck.ks_inner(exts.long(), key, p, rinv, 6, 6)
    with pytest.raises(ValueError):             # a CPU tensor among CUDA ones
        ck.ks_inner(exts, key.cpu(), p, rinv, 6, 6)
    with pytest.raises(ValueError):
        ck.ks_inner(exts, key, p.cpu(), rinv, 6, 6)
    with pytest.raises(ValueError):             # not a power of two
        ck.ks_inner(exts[..., :12].contiguous(), key[..., :12].contiguous(),
                    p, rinv, 6, 6)
    q = exts[0, :6].expand(2, 6, 1 << 8)
    with pytest.raises(ValueError):             # not contiguous
        ck.moddown_tail(q, q.contiguous(), p[:6].contiguous(), rinv[:6])


# (algo, N, q rows): the composite rescale from the top level of each
# benchmark cell's chain (hybrid1 N=128: 95 q rows; MEHP24 N=128: 89;
# MEHP24 N=512: 105) and of the ring-2^18 chain (hybrid1 N=1024: 115), all
# at comp = 2, on the registry's primes
RESCALE_CHAINS = {
    "hybrid1 N=128": ("hybrid1", 128, 95),
    "mehp24 N=128": ("mehp24", 128, 89),
    "mehp24 N=512": ("mehp24", 512, 105),
    "hybrid1 N=1024 ring 2^18": ("hybrid1", 1024, 115),
}


@pytest.mark.parametrize("name", list(RESCALE_CHAINS))
def test_rescale_bit_equal_to_plain(device, name):
    """For 2 and 3 polys, on random residues and on residues at p - 1:
    rescale_lift bit-equal to rescale_lift_t, and the composed rescale
    (CkksContext._rescale_data: K2 of the dropped rows, the lift, K1 of
    the kept rows, moddown_tail on the kept rows in place) bit-equal to
    the same steps' plain versions, one launch of each kernel a call."""
    from sorting_fhe_tpu_torch.core import ckks
    from sorting_fhe_tpu_torch.core import cuda_keyswitch as ck
    from sorting_fhe_tpu_torch.core import cuda_rescale as cr
    from sorting_fhe_tpu_torch.registry import full_config, get_params
    algo, N, l = RESCALE_CHAINS[name]
    ctx = ckks.CkksContext.__new__(ckks.CkksContext)
    ctx._init_common(full_config(get_params(algo, N)), device)
    P, n, tabs = ctx.params, ctx.n, ctx.params.ntt
    assert (P.nq, P.comp) == (l, 2)
    lo = l - 2
    drop, keep, pinv = ctx._rescale_consts(l)
    q_p = ctx.tables(l).q_p
    up = torch.arange(lo, l, device=device)
    down = torch.arange(lo, device=device)
    rng = np.random.default_rng(l)
    for k in (2, 3):
        for top in (False, True):
            p = np.asarray(P.q[:l], np.uint64).reshape(-1, 1)
            x = np.broadcast_to(p - 1, (k, l, n)) if top else \
                rng.integers(0, 1 << 62, size=(k, l, n), dtype=np.uint64) % p
            x = torch.from_numpy(np.ascontiguousarray(
                x, dtype=np.uint32).view(np.int32)).to(device)
            c = x[:, lo:].contiguous()
            before = cuda_lib.launches.copy()
            lift = cr.rescale_lift(c, drop, keep)
            assert cuda_lib.launches["rescale_lift"] == \
                before["rescale_lift"] + 1
            assert torch.equal(lift, cr.rescale_lift_t(c, drop, keep)), \
                (k, top)
            before = cuda_lib.launches.copy()
            got = ctx._rescale_data(x, l)
            assert [cuda_lib.launches[kk] - before[kk] for kk in (
                "rescale_lift", "moddown_tail")] == [1, 1]
            coeffs = ntt_inv_t(c, tabs.p[up], tabs.ipsi[up], tabs.n_inv[up])
            lift = ntt_fwd_t(cr.rescale_lift_t(coeffs, drop, keep),
                             tabs.p[down], tabs.psi[down])
            want = ck.moddown_tail_t(x[:, :lo], lift, q_p[:lo], pinv)
            assert torch.equal(got, want), (k, top)
