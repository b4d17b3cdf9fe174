"""The port's PlainContext (utils/plain.py, a copy) against the JAX
package's: each drives the port's models to the same outputs with the
same census of context calls (bitonic N=8, hybrid1 N=16).

At most two tier-1 tests per file (see tests/test_torch_serial.py).
"""

import collections

import numpy as np
import pytest
import torch

from sorting_fhe_tpu.utils.plain import PlainContext as JPlain
from sorting_fhe_tpu_torch import registry as treg
from sorting_fhe_tpu_torch.models.bitonic import BitonicSort
from sorting_fhe_tpu_torch.models.direct_sort import DirectSort
from sorting_fhe_tpu_torch.utils.plain import PlainContext as TPlain
from sorting_fhe_tpu_torch.utils.testvec import vector_with_min_diff

torch.set_num_threads(1)   # one thread per test worker: six share the cores

CENSUS_OPS = ("rotate", "mult", "square", "mult_plain", "mult_scalar",
              "add", "sub", "rsub", "make_plaintext", "rotate_plaintext",
              "rescale", "level_reduce", "fast_rotation",
              "fast_rotation_precompute")


def _census(Plain, ring):
    ctx = Plain(ring)
    ctx.calls = collections.Counter()
    for name in CENSUS_OPS:
        def counted(*args, _fn=getattr(ctx, name), _name=name, **kw):
            ctx.calls[_name] += 1
            return _fn(*args, **kw)
        setattr(ctx, name, counted)
    return ctx


def _bitonic8(ctx):
    v = vector_with_min_diff(8, 0, 255, 0.01, np.random.default_rng(19))
    out = BitonicSort(ctx, 8).sort(ctx.encrypt(v, slots=8),
                                   treg.get_params("bitonic", 8).sign_config())
    return ctx.decrypt(out)[:8]


def _hybrid1_16(ctx):
    v = vector_with_min_diff(16, 0, 1, 1 / 16, np.random.default_rng(23))
    ds = DirectSort(ctx, 16, use_minimal_keys=True)
    out = ds.sort_hybrid1(ctx.encrypt(v, slots=16),
                          treg.get_params("hybrid1", 16).sign_config())
    return ctx.decrypt(out)[:16]


@pytest.mark.parametrize("run,ring", [(_bitonic8, 1 << 13),
                                      (_hybrid1_16, 1 << 10)],
                         ids=["bitonic N=8", "hybrid1 N=16"])
def test_plain_context_matches_jax(run, ring):
    jctx, tctx = _census(JPlain, ring), _census(TPlain, ring)
    np.testing.assert_array_equal(run(tctx), run(jctx))
    assert tctx.calls == jctx.calls and tctx.calls["rotate"] > 0
    assert (tctx.mult_count, tctx.rot_count) == \
        (jctx.mult_count, jctx.rot_count)
