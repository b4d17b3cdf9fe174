"""The row-sharded evaluator (sorting_fhe_tpu_torch/parallel/evaluator.py)
against the port's single-device context, and, under -m slow, against the
JAX package's sharded runs, on meshes of 8 CPU slots.

Geometries: tests/test_multichip.py's.  test_sharded_full_sort's (ring
2^8, depth 26, comp 1, dnum 4: 28 q rows in blocks of 4, the last slot's
empty, and 7 special rows, the last slot's block empty), a comp-2 chain
of 23 q rows in blocks of 3 (a rescale from 19 limbs drops rows 17 and
18, which lie on two slots), and test_sharded_homomorphic_step's (depth
14, dnum 2: 16 q and 8 special rows).

Tolerances: every sharded op and sort is exact integer arithmetic on the
same canonical residues as the single-device one, so results must be
torch.equal (and the op census equal); so must the bootstrap's
mod_raise, whose float32 correction count every slot sums from all the
base rows exactly as one device does, conjugate and mult_monomial.  The
decrypt gates are JAX's (1e-2 for the homomorphic step, 0.5 for the
one-iteration rank, 0.02 for the sort) and the hybrid1 sort's 0.01.  Under -m slow the JAX runs use
limb_pad=1 (ROADMAP queue 3: padding rows change the JAX digit split), so
the port's sharded outputs must equal them bit for bit.  Two tier-1 tests
only: `--dist loadfile` queues files by test count (ROADMAP, test time
budget); no JAX code is compiled in them.
"""

import numpy as np
import pytest
import torch

from sorting_fhe_tpu_torch.core.ckks import Ciphertext, CkksContext
from sorting_fhe_tpu_torch.core.interop import residues_to_numpy
from sorting_fhe_tpu_torch.core.params import CkksConfig
from sorting_fhe_tpu_torch.models.direct_sort import DirectSort
from sorting_fhe_tpu_torch.ops.sign import CompositeSignConfig, SignConfig
from sorting_fhe_tpu_torch.parallel.evaluator import shard_context
from sorting_fhe_tpu_torch.parallel.mesh import make_mesh, shard_ciphertext
from sorting_fhe_tpu_torch.utils.testvec import vector_with_min_diff

torch.set_num_threads(1)   # one thread per test worker: six share the cores

CPU = torch.device("cpu")
SORT_GEOM = dict(ring_dim=1 << 8, mult_depth=26, scale_bits=26, comp=1,
                 dnum=4)
STEP_GEOM = dict(ring_dim=1 << 8, mult_depth=14, scale_bits=26, comp=1,
                 dnum=2)
COMP2_GEOM = dict(ring_dim=1 << 8, mult_depth=10, scale_bits=52, comp=2,
                  dnum=4)
H1_GEOM = dict(ring_dim=1 << 9, mult_depth=38, scale_bits=26, comp=1,
               dnum=5)
N = 4


def _same(sct, ct, name):
    """A sharded result equals the single-device one: residues and
    metadata."""
    assert torch.equal(sct.gather().data, ct.data), name
    assert (sct.scale, sct.noise_deg, sct.slots, sct.limbs) == \
        (ct.scale, ct.noise_deg, ct.slots, ct.limbs), name


def _census_gathers(census: dict, boots: int = 0) -> dict:
    """The gathers a census implies: a digit gather per key switch that
    decomposes (hoisted rotations share their decompose's; conjugations
    count as rotate_fused), a ModDown gather per key switch, a rescale
    gather per rescale, and a raise gather per bootstrap."""
    ks = sum(census.get(op, 0) for op in ("mult_relin", "square_relin",
                                          "rotate_fused", "fast_rotate"))
    want = {"digit": ks - census.get("fast_rotate", 0)
            + census.get("decompose", 0), "moddown": ks,
            "rescale": census.get("rescale", 0), "raise": boots}
    return {tag: n for tag, n in want.items() if n}


def _hoisted(c, x, y):
    """Two rotations of x from one hoisted decomposition, added."""
    pre = c.fast_rotation_precompute(x)
    return c.add(c.fast_rotation(x, 1, pre), c.fast_rotation(x, 2, pre))


def _check_ops(geom, levels, mesh, rng):
    """Every row-sharded op torch.equal to the single-device op, at the
    full level and at `levels`, with the same census and the gathers it
    implies."""
    ctx = CkksContext(CkksConfig(**geom), device="cpu")
    ctx.gen_rotation_keys([1, 2, 3])
    sctx = shard_context(ctx, mesh)
    P = ctx.params
    v, w = rng.uniform(-1, 1, 8), rng.uniform(-1, 1, 8)
    a, b = ctx.encrypt(v, slots=8), ctx.encrypt(w, slots=8)
    sa, sb = sctx.shard(a), sctx.shard(b)
    e = sctx.encrypt(v, slots=8)          # fresh randomness: decrypt it
    assert [blk.shape[1] for blk in e.blocks] == \
        [blk.shape[1] for blk in sa.blocks]
    assert np.abs(sctx.decrypt(e)[:8] - v).max() < 1e-4
    _same(sctx.fresh_zero(8), ctx.fresh_zero(8), "fresh_zero")

    def both(op):
        """op(context, x, y) on both contexts: (sharded, single)."""
        return op(sctx, sa, sb), op(ctx, a, b)

    ctx.op_counts.clear()
    mesh.clear_gathers()
    single, runs = {}, []
    for l in levels:
        def at(c, x, y, l=l):
            return c.level_reduce(x, l), c.level_reduce(y, l)
        runs += [
            (f"mult+rescale@{l}", lambda c, x, y, at=at: c.rescale(
                c.mult(*at(c, x, y)))),
            (f"rotate@{l}", lambda c, x, y, at=at: c.rotate(at(c, x, y)[0],
                                                            3)),
            (f"square@{l}", lambda c, x, y, at=at: c.square(at(c, x, y)[1]))]
    runs += [
        ("hoisted", _hoisted),
        ("adjust_to", lambda c, x, y: c.adjust_to(
            x, x.limbs - 2 * P.comp, c.canonical_scale(x.limbs - 2 * P.comp))),
        ("match_add", lambda c, x, y: c.add(c.rescale(c.mult(x, y)), x)),
        ("mult_scalar", lambda c, x, y: c.mult_scalar(x, -0.3)),
        ("mult_int", lambda c, x, y: c.mult_int(c.negate(x), 3)),
        ("add_scalar", lambda c, x, y: c.sub(c.add(x, 0.25), y)),
        ("mult_plain", lambda c, x, y: c.mult_plain(x, w)),
        ("pt ops", lambda c, x, y: c.add(x, c.rotate_plaintext(
            c.make_plaintext(w, x.limbs, x.scale, 8), 2))),
        ("zero_like", lambda c, x, y: c.sub(c.zero_like(x), y)),
    ]
    for name, op in runs:
        s_out, out = both(op)
        _same(s_out, out, name)
        single[name] = out
    # each op ran once on each context; the gathers follow the census
    census = {k: n // 2 for k, n in ctx.op_counts.items()}
    assert all(n % 2 == 0 for n in ctx.op_counts.values()), ctx.op_counts
    assert {t: g["count"] for t, g in mesh.gathers.items()} == \
        _census_gathers(census)
    assert [g["tag"] for g in mesh.gather_log][:3] == \
        ["digit", "moddown", "rescale"]
    # a 3-component ciphertext: relinearize, and zero padding in an add
    d3 = torch.cat([a.data, b.data[:1]])
    c3 = Ciphertext(d3, a.scale, 1, 8)
    s3 = sctx.shard(c3)
    _same(sctx.relinearize(s3), ctx.relinearize(c3), "relinearize")
    _same(sctx.add(sa, s3), ctx.add(a, c3), "pad")
    for name, out in single.items():
        s_out = sctx.shard(out)
        assert np.array_equal(sctx.decrypt(s_out), ctx.decrypt(out)), name
    return ctx, sctx, sa


def _check_boot_ops(ctx, sctx, a, mesh):
    """The bootstrap's ops torch.equal to the single-device ones:
    mod_raise from the base limbs and from 5 (rows on two slots), with one
    "raise" gather each; conjugate and mult_monomial (X^(n/2), X^(3n/2),
    X^5) at the full level and at 10 limbs, the conjugations with the two
    gathers of a key switch each."""
    P, sa = ctx.params, sctx.shard(a)
    sctx.gen_conj_key()
    mesh.clear_gathers()
    for l0 in (P.base_limbs, 5):
        _same(sctx.mod_raise(sctx.level_reduce(sa, l0)),
              ctx.mod_raise(ctx.level_reduce(a, l0)), f"mod_raise@{l0}")
    for l in (P.nq, 10):
        x, sx = ctx.level_reduce(a, l), sctx.level_reduce(sa, l)
        _same(sctx.conjugate(sx), ctx.conjugate(x), f"conjugate@{l}")
        for power in (P.n // 2, 3 * P.n // 2, 5):
            _same(sctx.mult_monomial(sx, power), ctx.mult_monomial(x, power),
                  f"mult_monomial X^{power}@{l}")
    assert {t: g["count"] for t, g in mesh.gathers.items()} == \
        {"raise": 2, "digit": 2, "moddown": 2}


def test_sharded_ops_match_single_device():
    mesh = make_mesh(devices=[CPU] * 8)
    rng = np.random.default_rng(11)
    # 28 q rows: blocks of 4 from row 0, 4, ..., 24, the last slot empty;
    # from 25 limbs a rescale empties slot 6, and at 10 limbs slots 3-7
    # hold no q row
    ctx, sctx, sa = _check_ops(SORT_GEOM, (28, 25, 10), mesh, rng)
    assert [blk.shape[1] for blk in sa.blocks] == [4] * 7 + [0]
    assert sctx.occupancy(10) == [4, 4, 2, 0, 0, 0, 0, 0]
    assert [len(S.rows_sp) for S in sctx.mesh_tables.level(10)] == \
        [1] * 7 + [0]
    fresh = ctx.encrypt(np.ones(4), slots=4)
    assert torch.equal(shard_ciphertext(fresh, mesh).gather().data,
                       fresh.data)
    _check_boot_ops(ctx, sctx, fresh, mesh)
    # a context under a key budget shards too: only the relin key is
    # placed, the store makes a streamed key's blocks on first use
    # (tests/test_torch_sharded_stream.py)
    streamed = CkksContext(CkksConfig(rot_key_budget_mb=1, **SORT_GEOM),
                           device="cpu")
    streamed.gen_rotation_keys([1])
    assert set(shard_context(streamed, mesh).mesh_tables.keys) == {"relin"}
    assert streamed.rot_keys.regen_count == 0
    # comp 2, 23 q rows in blocks of 3: the rescale from 19 limbs drops
    # row 18 (slot 6) and then row 17 (slot 5)
    ctx2, sctx2, sa2 = _check_ops(COMP2_GEOM, (23, 19, 9), mesh, rng)
    assert sctx2.occupancy(19) == [3, 3, 3, 3, 3, 3, 1, 0]
    _check_boot_ops(ctx2, sctx2, ctx2.encrypt(np.ones(4), slots=4), mesh)


def test_sharded_step_and_construct_rank():
    """test_sharded_homomorphic_step's and test_sharded_construct_rank's
    computations on the sharded context (test_multichip.py:39-83)."""
    mesh = make_mesh(devices=[CPU] * 8)
    rng = np.random.default_rng(7)
    ctx = CkksContext(CkksConfig(**STEP_GEOM), device="cpu")
    ctx.gen_rotation_keys([1])
    sctx = shard_context(ctx, mesh)
    v = vector_with_min_diff(N, 0, 1, 1.0 / N, rng)
    w = vector_with_min_diff(N, 0, 1, 1.0 / N, rng)

    def step(c, x, y):
        m = c.rescale(c.mult(x, y))
        return c.add(c.rotate(m, 1), m)

    a, b = ctx.encrypt(v, slots=N), ctx.encrypt(w, slots=N)
    mesh.clear_gathers()
    out = step(sctx, sctx.shard(a), sctx.shard(b))
    assert len({blk.device for blk in out.blocks}) == 1 and \
        len(out.blocks) == 8
    ref = step(ctx, a, b)
    _same(out, ref, "step")
    assert [g["tag"] for g in mesh.gather_log] == \
        ["digit", "moddown", "rescale", "digit", "moddown"]
    got = sctx.decrypt(out)[:N]
    assert np.abs(got - (np.roll(v * w, -1) + v * w)).max() < 1e-2

    x = ctx.encrypt(v, slots=N)
    cfg = SignConfig(CompositeSignConfig(3, 1, 1))
    ctx.op_counts.clear()
    rank = DirectSort(ctx, N).construct_rank(x, cfg)
    census = dict(ctx.op_counts)
    ctx.op_counts.clear()
    mesh.clear_gathers()
    srank = DirectSort(sctx, N).construct_rank(sctx.shard(x), cfg)
    _same(srank, rank, "construct_rank")
    assert dict(ctx.op_counts) == census
    assert {t: g["count"] for t, g in mesh.gathers.items()} == \
        _census_gathers(census)
    assert np.abs(sctx.decrypt(srank)[:N]
                  - np.argsort(np.argsort(v))).max() < 0.5


def _jax_sharded(geom, N, sort, seed_rng):
    """The JAX package's sharded sort (shard_context_tables on 8 virtual
    CPU devices, limb_pad=1) of vector_with_min_diff(N) from seed_rng:
    (output residues, input)."""
    from sorting_fhe_tpu.core.ckks import CkksContext as JC
    from sorting_fhe_tpu.core.params import CkksConfig as JCfg
    from sorting_fhe_tpu.models.direct_sort import DirectSort as JDS
    from sorting_fhe_tpu.ops import sign as jsign
    from sorting_fhe_tpu.parallel import mesh as jmesh
    jctx = JC(JCfg(limb_pad=1, **geom))
    jm = jmesh.make_mesh(8)
    jmesh.shard_context_tables(jctx, jm)
    v = vector_with_min_diff(N, 0, 1, 1.0 / N, seed_rng)
    ds = JDS(jctx, N)
    out = sort(ds, jmesh.shard_ciphertext(jctx.encrypt(v, slots=N), jm),
               jsign)
    assert len(out.data.sharding.device_set) == 8
    return np.asarray(out.data), v


def _port_sorts(geom, N, sort, seed_rng):
    """The port's single-device and sharded sorts of the same input on one
    context: (sharded context, single output, sharded output, input)."""
    from sorting_fhe_tpu_torch.ops import sign as tsign
    ctx = CkksContext(CkksConfig(**geom), device="cpu")
    v = vector_with_min_diff(N, 0, 1, 1.0 / N, seed_rng)
    ds = DirectSort(ctx, N)
    ct = ctx.encrypt(v, slots=N)
    out = sort(ds, ct, tsign)
    census = dict(ctx.op_counts)
    ctx.op_counts.clear()
    sctx = shard_context(ctx, make_mesh(devices=[CPU] * 8))
    sout = sort(DirectSort(sctx, N), sctx.shard(ct), tsign)
    assert dict(ctx.op_counts) == census
    _same(sout, out, "sort")
    return sctx, out, sout, v


@pytest.mark.slow
def test_sharded_full_sort_bit_equal_to_jax():
    """test_sharded_full_sort (test_multichip.py:175-187): DirectSort N=4
    on 8 slots, the port's sharded sort bit-equal to its single-device
    sort and to the JAX package's sharded sort."""
    def sort(ds, ct, sign):
        return ds.sort(ct)
    jout, jv = _jax_sharded(SORT_GEOM, N, sort, np.random.default_rng(7))
    sctx, out, sout, v = _port_sorts(SORT_GEOM, N, sort,
                                    np.random.default_rng(7))
    np.testing.assert_array_equal(jv, v)
    np.testing.assert_array_equal(residues_to_numpy(sout.gather().data),
                                  jout)
    assert np.abs(sctx.decrypt(sout)[:N] - np.sort(v)).max() < 0.02


@pytest.mark.slow
def test_sharded_hybrid1_n16():
    """__graft_entry__._sharded_hybrid1_sort's hybrid1 N=16 (ring 2^9,
    depth 38, comp 1, dnum 5, CompositeSign(3, 2, 2)) on 8 slots: within
    0.01 of np.sort, bit-equal to the port's single-device sort and to
    the JAX package's sharded sort at limb_pad=1."""
    def sort(ds, ct, sign):
        return ds.sort_hybrid1(ct, sign.SignConfig(
            sign.CompositeSignConfig(3, 2, 2), mult_depth=38))
    sctx, out, sout, v = _port_sorts(H1_GEOM, 16, sort,
                                    np.random.default_rng(3))
    assert np.abs(sctx.decrypt(sout)[:16] - np.sort(v)).max() < 0.01
    jout, _ = _jax_sharded(H1_GEOM, 16, sort, np.random.default_rng(3))
    np.testing.assert_array_equal(residues_to_numpy(sout.gather().data),
                                  jout)
