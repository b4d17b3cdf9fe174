"""MEHP24 (models/mehp24.py) through the torch port.

Tier-1: the port's sorts, each package's module on its own PlainContext,
give exactly the JAX module's outputs (sort_fg at the bench's N=128 ring-2^17
geometry, sort_cheb at N=4, sort_fg_multi and sort_large_array_fg on 32
values in blocks of 8), the rotation-key index sets are equal, and the
matrix ladders and masks on the port's CkksContext (CPU, ring 2^10)
decrypt to the plain ladders' values within 1e-8.  The N=128 case also
shows why the port's bench does not take the JAX bench's indicator
degree: with dg_i = dg_c = 3 both modules miss the 0.01 gate.

`slow` (deselected in tier-1): the same ladders and an encrypted sort_fg
at N=4 give ciphertexts bit-equal to the JAX package's.
"""

import numpy as np
import pytest
import torch

from sorting_fhe_tpu.utils.plain import PlainContext as JPlain
from sorting_fhe_tpu.utils.testvec import vector_with_min_diff
from sorting_fhe_tpu.models import mehp24 as JM
from sorting_fhe_tpu_torch import registry as treg
from sorting_fhe_tpu_torch.bench import mehp24_degrees
from sorting_fhe_tpu_torch.core.interop import residues_to_numpy
from sorting_fhe_tpu_torch.models import mehp24 as TM
from sorting_fhe_tpu_torch.utils.plain import PlainContext as TPlain

torch.set_num_threads(1)   # one thread per test worker: six share the cores

# each package's module with its own PlainContext
MODELS = ((JM, JPlain), (TM, TPlain))
# tests/test_bitonic_mehp24.py's encrypted ladder config
LADDER_CFG = dict(ring_dim=1 << 10, mult_depth=4, scale_bits=52, comp=2,
                  dnum=3)


def _vals(n, seed):
    return vector_with_min_diff(n, 0, 1, 1.0 / n, np.random.default_rng(seed))


def _sort_fg_n128(M, ctx, v, degrees=None):
    degrees = degrees or mehp24_degrees(treg.get_params("mehp24", 128))
    out = M.sort_fg(ctx, ctx.encrypt(v, slots=128 * 128), 128, *degrees)
    return ctx.decrypt(out)[:128]


def _sort_cheb_n4(M, ctx, v):
    out = M.sort_cheb(ctx, ctx.encrypt(v, slots=16), 4, -1.0, 1.0,
                      M.depth2degree(9), M.depth2degree(10))
    # sort_cheb leaves the sorted values in matrix column 0
    return ctx.decrypt(out)[0:16:4]


def _sort_fg_multi_32(M, ctx, v):
    parts = [ctx.encrypt(v[i * 8:(i + 1) * 8], slots=64) for i in range(4)]
    outs = M.sort_fg_multi(ctx, parts, 8, 3, 2, 3, 2)
    return np.concatenate([ctx.decrypt(o)[:8] for o in outs])


def _sort_large_32(M, ctx, v):
    out = M.sort_large_array_fg(ctx, ctx.encrypt(v, slots=64), 32, 8,
                                3, 2, 3, 2)
    return ctx.decrypt(out)[:32]


@pytest.mark.parametrize("run,n,ring", [
    (_sort_fg_n128, 128, 1 << 17),
    (_sort_cheb_n4, 4, 1 << 10),
    (_sort_fg_multi_32, 32, 1 << 12),
    (_sort_large_32, 32, 1 << 12),
], ids=["sort_fg_n128", "sort_cheb_n4", "sort_fg_multi", "sort_large"])
def test_sort_plain_matches_jax(run, n, ring):
    v = _vals(n, 7)
    jax_out, port_out = (run(M, Plain(ring), v) for M, Plain in MODELS)
    np.testing.assert_array_equal(port_out, jax_out)
    assert np.abs(port_out - np.sort(v)).max() < 0.01


def test_sort_fg_n128_jax_bench_degrees_miss_gate():
    """The JAX bench's sort_fg(ctx, ct, N, dg, 2, dg, 2) with dg = 3 at
    N=128: both modules agree, and both miss the gate in exact arithmetic;
    the reference fixture's dg_i = 4 (the port's bench) passes above."""
    assert mehp24_degrees(treg.get_params("mehp24", 128)) == (3, 2, 4, 2)
    v = _vals(128, 42)
    jax_out, port_out = (_sort_fg_n128(M, Plain(1 << 17), v, (3, 2, 3, 2))
                         for M, Plain in MODELS)
    np.testing.assert_array_equal(port_out, jax_out)
    assert np.abs(port_out - np.sort(v)).max() > 0.01


@pytest.mark.parametrize("N,ring,block", [
    (128, 1 << 17, None), (256, 1 << 17, None), (512, 1 << 17, 256),
    (8, 1 << 8, None), (16, 1 << 8, 8)])
def test_build_sorter_blocks_where_the_matrix_does_not_fit(monkeypatch, N,
                                                          ring, block):
    """bench.build_sorter takes sort_fg while the N x N matrix fits the
    ring's slots, else sort_large_array_fg in blocks of the largest width
    that fits, its ladders' and strides' keys made at build."""
    from sorting_fhe_tpu_torch.bench import build_sorter
    calls, keys = [], set()
    for name in ("sort_fg", "sort_large_array_fg"):
        monkeypatch.setattr(TM, name, lambda ctx, ct, n, *rest, _name=name:
                            calls.append((_name, n, rest)))
    ctx = TPlain(ring)
    monkeypatch.setattr(ctx, "gen_rotation_keys",
                        lambda idx: keys.update(k % (ring // 2) for k in idx))
    p = treg.get_params("mehp24", N)
    sort_fn, slots, _ = build_sorter(ctx, "mehp24", N, p)
    sort_fn(ctx.encrypt(_vals(N, 3), slots=slots), None)
    degrees = mehp24_degrees(p)
    if block is None:
        assert slots == N * N and calls == [("sort_fg", N, degrees)]
        want = TM.rotation_indices(N)
    else:
        assert slots == block * block <= ring // 2 < 4 * slots
        assert calls == [("sort_large_array_fg", N, (block, *degrees))]
        want = TM.rotation_indices(block) + TM.stride_indices(N, block)
    assert keys - {0} == {k % (ring // 2) for k in want} - {0}


def test_rotation_indices_match_jax():
    for size in (128, 256, 512):
        assert TM.rotation_indices(size) == JM.rotation_indices(size)


def _ladders(ctx, M):
    """Each matrix ladder and mask of a 4 x 4 Mehp24 on one row vector."""
    m = M.Mehp24(ctx, 4)
    row0 = ctx.encrypt(np.arange(1.0, 5.0) / 8.0, slots=16)
    VR = m.replicate_row(row0)
    col0 = m.transpose_row(row0, True)
    return {
        "replicate_row": VR,
        "replicate_column": m.replicate_column(col0),
        "sum_rows": m.sum_rows(VR),
        "sum_columns": m.sum_columns(VR, True),
        "transpose_column": m.transpose_column(col0, True),
        "mask_row": m.mask_row(VR, 2),
        "mask_column": m.mask_column(VR, 1),
    }


def test_ladders_encrypted_port():
    from sorting_fhe_tpu_torch.core.ckks import CkksContext
    from sorting_fhe_tpu_torch.core.params import CkksConfig
    ctx = CkksContext(CkksConfig(**LADDER_CFG), device="cpu")
    pctx = TPlain(1 << 10)
    want = _ladders(pctx, TM)
    for name, ct in _ladders(ctx, TM).items():
        got = ctx.decrypt(ct)[:16]
        err = np.abs(got - pctx.decrypt(want[name])[:16]).max()
        assert err < 1e-8, (name, err)


@pytest.mark.slow
def test_ladders_bit_equal_to_jax():
    from sorting_fhe_tpu.core.ckks import CkksContext as JC
    from sorting_fhe_tpu.core.params import CkksConfig as JCfg
    from sorting_fhe_tpu_torch.core.ckks import CkksContext as TC
    from sorting_fhe_tpu_torch.core.params import CkksConfig as TCfg
    jctx = JC(JCfg(**LADDER_CFG))
    tctx = TC(TCfg(**LADDER_CFG), device="cpu")
    jl, tl = _ladders(jctx, JM), _ladders(tctx, TM)
    for name in jl:
        np.testing.assert_array_equal(np.asarray(jl[name].data),
                                      residues_to_numpy(tl[name].data),
                                      err_msg=name)


@pytest.mark.slow
def test_sort_fg_encrypted_n4_bit_equal_to_jax():
    """tests/test_bitonic_mehp24.py's encrypted sortFG config (ring 2^10,
    depth 32, dnum 6), with the bench's degrees (2, 2, 1, 2): that test's
    (2, 2, 2, 2) spends all 32 levels, and both packages then decrypt to
    about 0."""
    from sorting_fhe_tpu.core.ckks import CkksContext as JC
    from sorting_fhe_tpu.core.params import CkksConfig as JCfg
    from sorting_fhe_tpu_torch.core.ckks import CkksContext as TC
    from sorting_fhe_tpu_torch.core.params import CkksConfig as TCfg
    cfg = dict(ring_dim=1 << 10, mult_depth=32, scale_bits=52, comp=2,
               dnum=6)
    N = 4
    v = _vals(N, 5)
    runs = []
    for ctx, M in ((JC(JCfg(**cfg)), JM),
                   (TC(TCfg(**cfg), device="cpu"), TM)):
        out = M.sort_fg(ctx, ctx.encrypt(v, slots=N * N), N,
                        *mehp24_degrees(treg.get_params("mehp24", N)))
        runs.append((out, np.asarray(ctx.decrypt(out))[:N]))
    (jout, jv), (tout, tv) = runs
    np.testing.assert_array_equal(np.asarray(jout.data),
                                  residues_to_numpy(tout.data))
    for got in (jv, tv):
        assert np.abs(got - np.sort(v)).max() < 0.01, got
