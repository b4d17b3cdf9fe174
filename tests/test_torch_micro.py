"""The port's per-op micro table and NTT throughput
(sorting_fhe_tpu_torch/bench.py `micro_bench`, `ntt_bench`) against the
repository's bench.py.

Tier-1:
  * on a ring-2^8 CPU context (limb_pad=1), micro_bench and
    ntt_bench(8, device="cpu") return the JAX functions' keys
    (bench.py:102-234), every value finite and > 0;
  * the micro table's bodies (the context's `_relin`, `_rescale_data`,
    `_decompose` and `_fast_rotate`), one repetition each, bit-equal to
    the JAX bench's bodies over `_kj_mult_relin`, `_kj_rescale`,
    `_kj_decompose` and `_kj_fast_rotate` on the same numpy residues (the
    keys random residues set as the context's relinearisation key and
    rotation key 1, as in tests/test_torch_ckks.py), at
    tests/test_torch_ckks.py's ring 2^12 config and limb count, so no
    JAX op is compiled at a shape that test does not compile.

At most two tier-1 tests in this file (ROADMAP, test time budget).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

from sorting_fhe_tpu.core import ckks as jck
from sorting_fhe_tpu.core.params import CkksConfig as JCfg
from sorting_fhe_tpu_torch import bench
from sorting_fhe_tpu_torch.core import ckks as tck
from sorting_fhe_tpu_torch.core.interop import (residues_to_numpy,
                                                residues_to_torch)
from sorting_fhe_tpu_torch.core.params import CkksConfig as TCfg

torch.set_num_threads(1)   # one thread per test worker: six share the cores

ROOT_BENCH = Path(__file__).resolve().parents[1] / "bench.py"
# the JAX micro_bench's keys, in its order (bench.py:185-229)
MICRO_KEYS = ("mult_relin_ms", "rescale_ms", "hoist_precompute_ms",
              "rot_composed_1_ms", "rot_hoisted_1_ms", "rot_composed_4_ms",
              "rot_hoisted_4_ms", "sinc_host_ns_per_eval")
NTT_KEYS = ("metric", "value", "unit", "vs_baseline")
# tests/test_torch_ckks.py's config
CKKS_CFG = dict(ring_dim=1 << 12, mult_depth=4, scale_bits=52, comp=2,
                dnum=2, seed=11, limb_pad=1)


def test_micro_and_ntt_bench_keys():
    src = ROOT_BENCH.read_text()
    for k in MICRO_KEYS:     # rot_* keys come from f"rot_composed_{m}_ms"
        tmpl = k.replace("_1_", "_{m}_").replace("_4_", "_{m}_")
        assert f'out["{k}"]' in src or f'out[f"{tmpl}"]' in src, k
    assert 'for m in (1, 4):' in src
    assert '"metric": f"ntt_limb_transforms_per_s_ring2e{ring_log}"' in src

    ctx = tck.CkksContext(TCfg(ring_dim=1 << 8, mult_depth=6, scale_bits=26,
                               comp=1, dnum=2, seed=77, limb_pad=1),
                          device="cpu")
    micro = bench.micro_bench(ctx)
    assert tuple(micro) == MICRO_KEYS
    assert all(np.isfinite(v) and v > 0 for v in micro.values()), micro
    ntt = bench.ntt_bench(8, device="cpu")
    assert tuple(ntt) == NTT_KEYS
    assert ntt["metric"] == "ntt_limb_transforms_per_s_ring2e8"
    assert np.isfinite(ntt["value"]) and ntt["value"] > 0
    assert ntt["unit"] == "1/s" and ntt["vs_baseline"] is None


def _jax_bodies(j, l, relin, rk, perm):
    """The repository's bench.py micro bodies (bench.py:185-219), one
    repetition each."""
    T, comp = j.tables(l), j.params.comp

    def rot_chain(m, hoisted):
        def body(a):
            if hoisted:
                pre = jck._kj_decompose(a[1], T)
                for _ in range(m):
                    a = jck._kj_fast_rotate(a, pre, rk, perm, T)
            else:
                for _ in range(m):
                    pre = jck._kj_decompose(a[1], T)
                    a = jck._kj_fast_rotate(a, pre, rk, perm, T)
            return a
        return body

    bodies = {
        "mult_relin": lambda a: jck._kj_mult_relin(a, a, relin, T),
        "rescale": lambda a: jnp.concatenate(
            [jck._kj_rescale(a, j._rescale_consts(l), T)[:, :l - comp],
             jnp.zeros((2, comp, j.n), jnp.uint32)], axis=1),
        "hoist_precompute": lambda a: a.at[0].set(
            jck._kj_decompose(a[1], T)[0, :l])}
    for m in (1, 4):
        bodies[f"rot_composed_{m}"] = rot_chain(m, False)
        bodies[f"rot_hoisted_{m}"] = rot_chain(m, True)
    return bodies


def test_micro_bodies_bit_equal_jax():
    j = jck.CkksContext.__new__(jck.CkksContext)
    j._init_common(JCfg(**CKKS_CFG))
    t = tck.CkksContext.__new__(tck.CkksContext)
    t._init_common(TCfg(**CKKS_CFG), "cpu")
    P = t.params
    n, l = P.n, P.nq - 2          # tests/test_torch_ckks.py's limb count
    rng = np.random.default_rng(5)
    p = np.asarray(P.q[:l], dtype=np.int64)
    # bench.py's draw: per prime, [2, n] residues from default_rng
    a = np.stack([rng.integers(0, p[i], size=(2, n), dtype=np.int64)
                  .astype(np.uint32) for i in range(l)], axis=1)
    pa = np.asarray(P.all_primes, dtype=np.uint64).reshape(-1, 1)
    relin, rk = ((rng.integers(0, 1 << 62, size=(P.cfg.dnum, 2,
                                                 len(P.all_primes), n),
                               dtype=np.uint64) % pa).astype(np.uint32)
                 for _ in range(2))
    want = _jax_bodies(j, l, jnp.asarray(relin), jnp.asarray(rk), j._perm(1))
    t.relin_key = residues_to_torch(relin, "cpu")
    t.rot_keys[1] = residues_to_torch(rk, "cpu")
    got = bench.micro_bodies(t, l)
    assert list(got) == list(want) == [k[:-3] for k in MICRO_KEYS[:-1]]
    ta = residues_to_torch(a, "cpu")
    for name, body in got.items():
        out = body(ta)
        assert out.dtype == torch.int32 and out.shape == ta.shape, name
        np.testing.assert_array_equal(
            residues_to_numpy(out), np.asarray(want[name](jnp.asarray(a))),
            name)
