"""The port's limb-sharded key switch (sorting_fhe_tpu_torch/parallel/)
against the port's single-device ops and against the JAX package's
ShardedKeyswitch, on meshes of CPU slots.

Geometries of tests/test_multichip.py: ring 2^8, depth 14, scale_bits 26,
comp 1, dnum 2 (nq 16, 8 special primes) on 8 slots, and dnum 3 with 8
special primes on 4 slots, where a digit boundary (alpha 6) falls inside
slot 1's rows 4..7.  Both ops are exact integer arithmetic on canonical
residues, so the sharded results must equal the single-device ones bit
for bit; the decrypt gates are JAX's (1e-2).  Two tier-1 tests only:
`--dist loadfile` queues files by test count (ROADMAP, test time budget).
"""

import numpy as np
import pytest
import torch

from sorting_fhe_tpu.core.ckks import CkksContext as JCtx
from sorting_fhe_tpu.core.ckks import Ciphertext as JCt
from sorting_fhe_tpu.core.params import CkksConfig as JCfg
from sorting_fhe_tpu.parallel import mesh as jmesh
from sorting_fhe_tpu.parallel.collective import ShardedKeyswitch as JSK
from sorting_fhe_tpu_torch.core.ckks import Ciphertext, CkksContext
from sorting_fhe_tpu_torch.core.interop import (residues_to_numpy,
                                                residues_to_torch)
from sorting_fhe_tpu_torch.core.params import CkksConfig
from sorting_fhe_tpu_torch.parallel.collective import ShardedKeyswitch
from sorting_fhe_tpu_torch.parallel.mesh import (
    _put, key_sharding, limb_sharding, make_mesh, replicated,
    shard_ciphertext, shard_context_tables)
from sorting_fhe_tpu_torch.utils.testvec import vector_with_min_diff

CPU = torch.device("cpu")
GEOM = dict(ring_dim=1 << 8, mult_depth=14, scale_bits=26, comp=1)
N = 4


def _check_ops(ctx, mesh, rng):
    """mult_relin and rotate(1), rotate(3) on the mesh: torch.equal to the
    port's single-device ops, within 1e-2 of v*w and np.roll once
    decrypted, and exactly two logged gathers per op with JAX's byte
    counts.  Returns the ShardedKeyswitch."""
    v = vector_with_min_diff(N, 0, 1, 1.0 / N, rng)
    w = vector_with_min_diff(N, 0, 1, 1.0 / N, rng)
    a, b = ctx.encrypt(v, slots=N), ctx.encrypt(w, slots=N)
    sa, sb = shard_ciphertext(a, mesh), shard_ciphertext(b, mesh)
    assert [blk.shape[1] for blk in sa.blocks] == \
        [ctx.params.nq // mesh.size] * mesh.size
    assert torch.equal(sa.gather().data, a.data)
    sk = ShardedKeyswitch(ctx, mesh)
    want = sk.collective_bytes(k=2)
    mesh.gather_log.clear()
    counts = (ctx.mult_count, ctx.rot_count)
    out = sk.mult_relin(sa, sb)
    assert torch.equal(out.gather().data, ctx.mult(a, b).data)
    got = ctx.decrypt(ctx.rescale(out.gather()))[:N]
    assert np.abs(got - v * w).max() < 1e-2
    for k in (1, 3):
        r = sk.rotate(sa, k)
        assert torch.equal(r.gather().data, ctx.rotate(a, k).data), k
        assert np.abs(ctx.decrypt(r.gather())[:N]
                      - np.roll(v, -k)).max() < 1e-2, k
    # each op: its own and the single-device op's count
    assert (ctx.mult_count, ctx.rot_count) == (counts[0] + 2, counts[1] + 4)
    log = [(g["tag"], g["bytes_per_slot"]) for g in mesh.gather_log]
    assert log == [("digit", want["digit_allgather_B"]),
                   ("moddown", want["moddown_allgather_B"])] * 3, log
    return sk


def test_mesh_keyswitch_matches_single_device():
    if not torch.cuda.is_available():       # no quiet CPU fallback
        with pytest.raises(RuntimeError):
            make_mesh()
    rng = np.random.default_rng(7)
    ctx = CkksContext(CkksConfig(dnum=2, **GEOM), device="cpu")
    ctx.gen_rotation_keys([1, 3])
    mesh = make_mesh(devices=[CPU] * 8)
    assert shard_context_tables(ctx, mesh) is ctx
    sk = _check_ops(ctx, mesh, rng)
    # JAX's counts (test_multichip.py:114-115, :141-142)
    b = sk.collective_bytes(k=2)
    assert b["digit_allgather_B"] == 7 * 16 * 256 * 4 // 8 == 14336
    assert b["moddown_allgather_B"] == 7 * 2 * 8 * 256 * 4 // 8 == 14336
    census = {"mult_relin": 10, "rotate_fused": 5, "fast_rotate": 6,
              "decompose": 2, "square_relin": 0}
    bud = sk.comm_budget(census)
    assert (bud["keyswitch_ops"], bud["digit_gathers"]) == (21, 17)
    assert bud["total_receive_B"] == (17 * b["digit_allgather_B"]
                                      + 21 * b["moddown_allgather_B"])

    # _put: a dimension that does not divide the mesh is replicated
    x = torch.arange(2 * 15 * 3).reshape(2, 15, 3)
    assert all(torch.equal(blk, x) for blk in _put(x, mesh,
                                                   limb_sharding(mesh)))
    blocks = _put(ctx.relin_key, mesh, key_sharding(mesh))
    assert [tuple(blk.shape) for blk in blocks] == \
        [(2, 2, 3, 256)] * 8                        # 24 rows / 8 slots
    assert torch.equal(torch.cat(blocks, dim=2), ctx.relin_key)
    assert all(blk is x for blk in _put(x, mesh, replicated(mesh)))
    with pytest.raises(ValueError):
        ShardedKeyswitch(ctx, make_mesh(devices=[CPU] * 3))

    # a digit boundary inside a slot's rows (test_multichip.py:147-172):
    # alpha 6, slot 1 owns rows 4..7 and digits [0:6], [6:12]
    ctx = CkksContext(CkksConfig(dnum=3, num_special_primes=8, **GEOM),
                      device="cpu")
    ctx.gen_rotation_keys([1, 3])
    assert (ctx.params.alpha, ctx.params.nq) == (6, 16)
    _check_ops(ctx, make_mesh(devices=[CPU] * 4), rng)


def test_mesh_keyswitch_matches_jax():
    """The same residues and keys through JAX's ShardedKeyswitch on the 8
    virtual CPU devices and the port's on 8 CPU slots: equal bit for bit
    (JAX's sharded ops equal its single-device ops on this geometry, so
    no tolerance is needed).  The JAX context's keys reach the port
    through interop (for_evaluation)."""
    jctx = JCtx(JCfg(dnum=2, **GEOM))
    jctx.gen_rotation_keys([1])
    jm = jmesh.make_mesh(8)
    jmesh.shard_context_tables(jctx, jm)
    b_pk, a_pk = jctx.encryptor.pk
    tctx = CkksContext.for_evaluation(
        CkksConfig(dnum=2, **GEOM), (np.asarray(b_pk), np.asarray(a_pk)),
        np.asarray(jctx.relin_key), {1: np.asarray(jctx.rot_keys[1])},
        device="cpu")
    tm = make_mesh(devices=[CPU] * 8)

    P = tctx.params
    rng = np.random.default_rng(2024)
    p = np.asarray(P.q, dtype=np.uint64).reshape(-1, 1)
    a, b = ((rng.integers(0, 1 << 62, size=(2, P.nq, P.n), dtype=np.uint64)
             % p).astype(np.uint32) for _ in range(2))
    scale = float(2 ** 26)

    def jct(x):
        return jmesh.shard_ciphertext(JCt(x, scale, 1, N), jm)

    def tct(x):
        return shard_ciphertext(Ciphertext(residues_to_torch(x, "cpu"),
                                           scale, 1, N), tm)

    jsk, tsk = JSK(jctx, jm), ShardedKeyswitch(tctx, tm)
    np.testing.assert_array_equal(
        np.asarray(jsk.mult_relin(jct(a), jct(b)).data),
        residues_to_numpy(tsk.mult_relin(tct(a), tct(b)).gather().data))
    np.testing.assert_array_equal(
        np.asarray(jsk.rotate(jct(a), 1).data),
        residues_to_numpy(tsk.rotate(tct(a), 1).gather().data))
