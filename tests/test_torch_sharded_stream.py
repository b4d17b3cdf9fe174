"""The key store's budget on the row-sharded evaluator
(sorting_fhe_tpu_torch/parallel/evaluator.py over a context with
`rot_key_budget_mb`) against the port's single-device streamed context,
on meshes of 8 CPU slots.

Tier-1: a ring-2^10 context (30 q + 15 special rows, dnum 2: a key of
0.70 MB) under a 1 MB budget, which holds one key and not two.
Rotations by three indices, twice over, and a hoisted pair, on the mesh
and on a second context of the same config on one device: every output
torch.equal, the same regenerations (the device keygen draws one
generator per (seed, g, digit), so a key made again has the same bits),
the store's bytes within the budget plus the one key in flight at every
regeneration, and the mesh's own key blocks (`mesh_tables.keys`) never
holding a streamed key, so that nothing outlives the store's eviction.

`slow`: tests/test_torch_keystore.py's mehp24 sort_fg under a 2 MB
budget on 8 slots, torch.equal to the single-device streamed sort with
the same regenerations, and within the 0.01 gate of the JAX package's
sort of the same input (its device keys are jax.random's, so the
comparison is by decrypted values).

At most two tier-1 tests in this file (ROADMAP, test time budget); no
JAX code runs in the tier-1 one.
"""

import numpy as np
import pytest
import torch

from sorting_fhe_tpu_torch.core.ckks import CkksContext
from sorting_fhe_tpu_torch.core.params import CkksConfig
from sorting_fhe_tpu_torch.parallel.evaluator import shard_context
from sorting_fhe_tpu_torch.parallel.mesh import KeyBlocks, make_mesh
from sorting_fhe_tpu_torch.utils.testvec import vector_with_min_diff

torch.set_num_threads(1)   # one thread per test worker: six share the cores

CPU = torch.device("cpu")
GEOM = dict(ring_dim=1 << 10, mult_depth=28, scale_bits=26, comp=1,
            dnum=2, seed=77, rot_key_budget_mb=1)
ROTS = (1, 3, 6)
N = 8


def _watch(ctx, budget: int, key_bytes: int) -> list:
    """Wrap ctx's key-store hook: before each regeneration, the store's
    bytes within the budget (what it holds then stays; the new key is
    the one in flight).  Returns the list of those byte counts."""
    seen, regen = [], ctx.rot_keys._regen

    def hook(kk):
        seen.append(ctx.rot_keys.resident_bytes)
        assert seen[-1] <= budget
        key = regen(kk)
        assert key.nbytes == key_bytes
        return key
    ctx.rot_keys._regen = hook
    return seen


def _ops(c, ct):
    """The rotations by ROTS twice over and a hoisted pair: outputs in
    order."""
    outs = [c.rotate(ct, k) for k in ROTS + ROTS]
    pre = c.fast_rotation_precompute(ct)
    outs += [c.fast_rotation(ct, 1, pre), c.fast_rotation(ct, 3, pre)]
    return outs


def test_sharded_rotations_under_budget_match_single_device(monkeypatch):
    monkeypatch.delenv("SORTING_FHE_KEY_BUDGET_MB", raising=False)
    v = vector_with_min_diff(N, 0, 1, 1.0 / N, np.random.default_rng(3))
    one = CkksContext(CkksConfig(**GEOM), device="cpu")
    ctx = CkksContext(CkksConfig(**GEOM), device="cpu")
    P = ctx.params
    key_bytes = P.cfg.dnum * 2 * len(P.all_primes) * P.n * 4
    budget = GEOM["rot_key_budget_mb"] << 20
    assert key_bytes < budget < 2 * key_bytes
    for c in (one, ctx):
        c.gen_rotation_keys(list(ROTS))
    ct = one.encrypt(v, slots=N)
    # a key made before sharding leaves the store: it is not in the
    # mesh's form
    ctx.rotate(ct, ROTS[0])
    assert list(ctx.rot_keys._lru) == [ROTS[0]]
    made = ctx.rot_keys.regen_count

    mesh = make_mesh(devices=[CPU] * 8)
    sctx = shard_context(ctx, mesh)
    assert list(ctx.rot_keys._lru) == [] and set(sctx.mesh_tables.keys) == \
        {"relin"}
    seen_one = _watch(one, budget, key_bytes)
    seen_mesh = _watch(ctx, budget, key_bytes)
    want = _ops(one, ct)
    got = _ops(sctx, sctx.shard(ct))
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g.gather().data, w.data), i
    assert one.rot_keys.regen_count == ctx.rot_keys.regen_count - made == \
        len(seen_mesh) == len(seen_one) > len(ROTS)
    assert seen_mesh == seen_one
    # the store holds the blocks of the last key and nothing else does
    (last,) = list(ctx.rot_keys._lru)
    entry = ctx.rot_keys[last]
    assert isinstance(entry, KeyBlocks) and entry.mesh is mesh
    assert ctx.rot_keys.resident_bytes == key_bytes <= budget
    assert set(sctx.mesh_tables.keys) == {"relin"}
    # the base context joins the blocks back: its rotation is unchanged
    assert torch.equal(entry.whole(), one._regen_rot_key(last))
    assert torch.equal(ctx.rotate(ct, last).data, one.rotate(ct, last).data)
    assert np.abs(sctx.decrypt(got[0])[:N] - np.roll(v, -ROTS[0])).max() \
        < 1e-3


@pytest.mark.slow
def test_sharded_mehp24_sort_under_budget(monkeypatch):
    """mehp24 sort_fg N=4 under a 2 MB budget on 8 slots: torch.equal to
    the single-device streamed sort with the same regenerations, and
    within 0.01 of the JAX package's streamed sort of the same input."""
    from sorting_fhe_tpu.core.ckks import CkksContext as JC
    from sorting_fhe_tpu.core.params import CkksConfig as JCfg
    from sorting_fhe_tpu.models.mehp24 import sort_fg as jsort_fg
    from sorting_fhe_tpu_torch.models.mehp24 import sort_fg
    monkeypatch.delenv("SORTING_FHE_KEY_BUDGET_MB", raising=False)
    cfg = dict(ring_dim=1 << 10, mult_depth=34, scale_bits=52, comp=2,
               dnum=4, rot_key_budget_mb=2)
    v = np.array([0.8, 0.3, 0.55, 0.05])
    one = CkksContext(CkksConfig(**cfg), device="cpu")
    ctx = CkksContext(CkksConfig(**cfg), device="cpu")
    ct = one.encrypt(v, slots=16)
    want = sort_fg(one, ct, 4, 2, 2, 1, 2)
    sctx = shard_context(ctx, make_mesh(devices=[CPU] * 8))
    got = sort_fg(sctx, sctx.shard(ct), 4, 2, 2, 1, 2)
    assert torch.equal(got.gather().data, want.data)
    assert ctx.rot_keys.regen_count == one.rot_keys.regen_count > \
        len(ctx.rot_keys)
    # a key of this chain is over the budget: the store keeps the last one
    assert ctx.rot_keys.resident_bytes == one.rot_keys.resident_bytes
    assert len(list(ctx.rot_keys._lru)) == 1
    assert set(sctx.mesh_tables.keys) == {"relin"}
    jctx = JC(JCfg(**cfg))
    jout = jsort_fg(jctx, jctx.encrypt(v, slots=16), 4, 2, 2, 1, 2)
    jgot = jctx.decrypt(jout)[:4]
    tgot = sctx.decrypt(got)[:4]
    assert np.abs(jgot - np.sort(v)).max() < 0.01
    assert np.abs(tgot - np.sort(v)).max() < 0.01
    assert np.abs(tgot - jgot).max() < 0.01
