"""EvalBootstrap on the row-sharded evaluator (parallel/evaluator.py):
mod_raise, a whole Bootstrapper.bootstrap and the bootstrapping sorts on
meshes of CPU slots, against the port's single-device context and, under
-m slow, against the JAX package.

Tier-1 (two tests: `--dist loadfile` queues files by test count, ROADMAP's
test time budget; no JAX code runs in them):
- mod_raise at tests/test_bootstrap.py's config (ring 2^8, depth 16,
  comp 2, dnum 3, hw 16: 35 q rows) on 35 slots, whose q blocks of one
  row are narrower than the 2 raised base rows, so the base rows lie on
  slots 0 and 1: torch.equal to one device, with exactly one "raise"
  gather of (D-1)/D of the [2, 2, n] coefficient rows;
- Bootstrapper(sctx, slots=4) at that config on 8 slots (blocks of 5):
  torch.equal to the single-device bootstrap of the same ciphertext, the
  same op census, the gathers the census implies (one "raise" per
  bootstrap) and the round trip's 1e-3 gate.

`slow`: tests/test_torch_bitonic_kway.py's bitonic N=8 with the real
BootstrapHook (ring 2^9, depth 30) on 8 slots, bit-equal to the JAX
package's single-device output and within its 2.0 gate; and the k-way
network k=2 M=2 with BootstrapHook (ring 2^10, depth 40, dnum 6, hw 32,
CompositeSign(3, 2, 5): tests/test_bootstrap_depth.py's k-way config at
a quarter of its N) on 8 slots, bit-equal to the port on one device and
within 0.01 of np.sort.

Every comparison with the port's single-device context is torch.equal:
the mesh runs the same integer arithmetic on the same residues, and the
raise's float32 count is summed from the same gathered rows in the same
order.
"""

import numpy as np
import pytest
import torch

from sorting_fhe_tpu_torch.bench import TimedHook
from sorting_fhe_tpu_torch.core.bootstrap import (PHASES, Bootstrapper,
                                                  BootstrapHook)
from sorting_fhe_tpu_torch.core.ckks import CkksContext
from sorting_fhe_tpu_torch.core.interop import residues_to_numpy
from sorting_fhe_tpu_torch.core.params import CkksConfig
from sorting_fhe_tpu_torch.parallel.evaluator import shard_context
from sorting_fhe_tpu_torch.parallel.mesh import make_mesh
from test_torch_sharded import _census_gathers, _same

torch.set_num_threads(1)   # one thread per test worker: six share the cores

CPU = torch.device("cpu")
BOOT_CFG = dict(ring_dim=1 << 8, mult_depth=16, scale_bits=52, comp=2,
                dnum=3, secret_hw=16)
KWAY_CFG = dict(ring_dim=1 << 10, mult_depth=40, scale_bits=52, comp=2,
                dnum=6, secret_hw=32)


@pytest.fixture(scope="module")
def boot_ctx():
    return CkksContext(CkksConfig(**BOOT_CFG), device="cpu")


def test_mod_raise_base_rows_on_two_slots(boot_ctx):
    ctx = boot_ctx
    D = 35
    mesh = make_mesh(devices=[CPU] * D)
    sctx = shard_context(ctx, mesh)
    l0 = Bootstrapper(ctx, 4).raise_limbs
    assert l0 == 2 and sctx.occupancy(l0)[:3] == [1, 1, 0]
    ct = ctx.level_reduce(ctx.encrypt(np.linspace(-1, 1, 4), slots=4), l0)
    mesh.clear_gathers()
    out = sctx.mod_raise(sctx.shard(ct))
    _same(out, ctx.mod_raise(ct), "mod_raise")
    assert [blk.shape[1] for blk in out.blocks] == [1] * D
    n = ctx.n
    assert mesh.gather_log == [{
        "tag": "raise", "shape": [2, l0, n], "dtype": "torch.int32",
        "bytes_per_slot": (D - 1) * 2 * l0 * n * 4 // D}]


def test_bootstrap_on_mesh_bit_equal(boot_ctx):
    ctx = boot_ctx
    bs = Bootstrapper(ctx, slots=4).setup_keys()
    v = np.random.default_rng(0).uniform(-1, 1, 4)
    ct = ctx.level_reduce(ctx.encrypt(v, slots=4), bs.raise_limbs)
    ctx.op_counts.clear()
    out = bs.bootstrap(ct)
    census = dict(ctx.op_counts)

    mesh = make_mesh(devices=[CPU] * 8)
    sctx = shard_context(ctx, mesh)
    sbs = Bootstrapper(sctx, slots=4).setup_keys()
    assert "conj" in sctx.mesh_tables.keys
    ctx.op_counts.clear()
    mesh.clear_gathers()
    sout = sbs.bootstrap(sctx.shard(ct))
    _same(sout, out, "bootstrap")
    assert dict(ctx.op_counts) == census
    assert {t: g["count"] for t, g in mesh.gathers.items()} == \
        _census_gathers(census, 1)
    assert list(sbs.phase_s) == list(PHASES)
    assert np.abs(sctx.decrypt(sout)[:4] - v).max() < 1e-3


@pytest.mark.slow
def test_bitonic_n8_bootstrap_on_mesh_against_jax():
    """test_bitonic_n8_real_bootstrap_against_jax's sort, the port's on 8
    slots: bit-equal to the JAX package's single-device sort, every
    bootstrap with its raise gather."""
    from sorting_fhe_tpu.core.bootstrap import BootstrapHook as JHook
    from sorting_fhe_tpu.core.ckks import CkksContext as JC
    from sorting_fhe_tpu.core.params import CkksConfig as JCfg
    from sorting_fhe_tpu.models.bitonic import BitonicSort as JBitonic
    from sorting_fhe_tpu.ops.sign import (SignConfig as JS,
                                          CompositeSignConfig as JCS)
    from sorting_fhe_tpu_torch.models.bitonic import BitonicSort
    from sorting_fhe_tpu_torch.ops.sign import (SignConfig,
                                                CompositeSignConfig)
    cfg = dict(ring_dim=1 << 9, mult_depth=30, scale_bits=52, comp=2,
               dnum=4, secret_hw=16)
    N = 8
    rng = np.random.default_rng(7)
    v = (rng.permutation(N).astype(np.float64) + 1.0) * 255.0 / (N + 1)
    jctx = JC(JCfg(**cfg))
    jout = JBitonic(jctx, N, bootstrap_level=8,
                    bootstrap_hook=JHook(jctx)).sort(
        jctx.encrypt(v, slots=N), JS(JCS(3, 2, 2), mult_depth=30))

    ctx = CkksContext(CkksConfig(**cfg), device="cpu")
    mesh = make_mesh(devices=[CPU] * 8)
    sctx = shard_context(ctx, mesh)
    hook = TimedHook(BootstrapHook(sctx))
    sout = BitonicSort(sctx, N, bootstrap_level=8, bootstrap_hook=hook).sort(
        sctx.encrypt(v, slots=N), SignConfig(CompositeSignConfig(3, 2, 2),
                                             mult_depth=30))
    assert len(hook.calls) > 0
    assert mesh.gathers["raise"]["count"] == len(hook.calls)
    np.testing.assert_array_equal(residues_to_numpy(sout.gather().data),
                                  np.asarray(jout.data))
    got = sctx.decrypt(sout)[:N]
    np.testing.assert_array_equal(got, np.asarray(jctx.decrypt(jout))[:N])
    assert np.abs(got - np.sort(v)).max() < 2.0, got


@pytest.mark.slow
def test_kway_bootstrap_hook_on_mesh():
    """k=2 M=2 with BootstrapHook on 8 slots: bit-equal to the port's
    single-device sort with the same census and bootstraps."""
    from sorting_fhe_tpu_torch.models.kway import KWaySorter
    from sorting_fhe_tpu_torch.ops.sign import (SignConfig,
                                                CompositeSignConfig)
    from sorting_fhe_tpu_torch.utils.testvec import vector_with_min_diff
    ctx = CkksContext(CkksConfig(**KWAY_CFG), device="cpu")
    N, depth = 4, KWAY_CFG["mult_depth"]
    v = vector_with_min_diff(N, 0, 1, 1.0 / N, np.random.default_rng(12))
    ct = ctx.encrypt(v, slots=N)
    sign = SignConfig(CompositeSignConfig(3, 2, 5), mult_depth=depth)

    def sort(c):
        hook = TimedHook(BootstrapHook(c))
        out = KWaySorter(c, 2, 2, mult_depth=depth,
                         bootstrap_hook=hook).sort(
            c.shard(ct) if c is not ctx else ct, sign)
        return out, len(hook.calls)

    out, boots = sort(ctx)
    census = dict(ctx.op_counts)
    ctx.op_counts.clear()
    mesh = make_mesh(devices=[CPU] * 8)
    sctx = shard_context(ctx, mesh)
    sout, sboots = sort(sctx)
    _same(sout, out, "kway")
    assert sboots == boots > 0
    assert dict(ctx.op_counts) == census
    assert {t: g["count"] for t, g in mesh.gathers.items()} == \
        _census_gathers(census, boots)
    assert np.abs(sctx.decrypt(sout)[:N] - np.sort(v)).max() < 0.01
