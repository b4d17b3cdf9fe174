"""The blind-sort CLI of the torch port (driver.py, __main__.py) and its
evaluation-only context, against the JAX package.

Tier-1:
  * an evaluation-only context loaded from files has no decryptor,
    decrypt raises RuntimeError, a missing rotation key raises KeyError,
    the server encrypts with the public key alone; a foreign context file
    raises ValueError; a JAX streaming config loads with its budget, and
    the server built on it keeps the keys it loaded pinned (no
    regeneration, over the budget) and still raises KeyError for a
    missing one;
  * the driver's fault, copied: built on a minimal key set, the driver's
    DirectSort (no minimal key mode) asks the hybrid sorts for rotations
    no key covers, the same set in both packages; the direct sort finds
    every key.

`slow`: the whole CLI in a separate process (direct N=4, ring 2^10,
--cpu), as tests/test_serial.py's test_cli_blind_sort_subprocess: at its
depth 26 the CLI's sign runs out of levels; at depth 38 it sorts.

At most two tier-1 tests per file (see tests/test_torch_serial.py).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sorting_fhe_tpu import serial as jserial
from sorting_fhe_tpu.core.params import CkksConfig as JCfg
from sorting_fhe_tpu.driver import SortContext as JSortContext
from sorting_fhe_tpu.utils.plain import PlainContext as JPlain
from sorting_fhe_tpu_torch import serial as tserial
from sorting_fhe_tpu_torch.core.ckks import CkksContext as TC
from sorting_fhe_tpu_torch.core.params import CkksConfig as TCfg
from sorting_fhe_tpu_torch.driver import SortContext as TSortContext
from sorting_fhe_tpu_torch.models.direct_sort import minimal_rotations
from sorting_fhe_tpu_torch.utils.plain import PlainContext as TPlain

torch.set_num_threads(1)   # one thread per test worker: six share the cores

CFG = dict(ring_dim=1 << 10, mult_depth=8, scale_bits=52, comp=2, dnum=3)
V = np.array([0.1, 0.2, 0.3, 0.4])
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def port_client(tmp_path_factory):
    """The port's client: material and one ciphertext on disk."""
    ctx = TC(TCfg(**CFG), device="cpu")
    ctx.gen_rotation_keys([1, 2, 4, -1])
    d = tmp_path_factory.mktemp("port_keyring")
    paths = tserial.save_eval_material(d, ctx)
    tserial.save_ciphertext(d / "in.npz", ctx.encrypt(V, slots=4))
    return ctx, paths, d


def test_evaluation_only_context(port_client, tmp_path):
    """The server's context from files: no secret, no key generation; a
    foreign context file is refused; under a JAX streaming config the
    loaded keys stay pinned."""
    tctx, paths, d = port_client
    (tmp_path / "x.json").write_text("{}")
    with pytest.raises(ValueError):
        tserial.load_config(tmp_path / "x.json")
    # a JAX streaming config, budget 1 MB: it loads, and a server built
    # on it pins the keys it loaded, which cannot be made again
    jserial.save_context(tmp_path / "s.json", JCfg(**CFG,
                                                   rot_key_budget_mb=1))
    assert tserial.load_config(tmp_path / "s.json").rot_key_budget_mb == 1
    streamed = tserial.load_eval_context(**{**paths, "cc": tmp_path / "s.json"},
                                         device="cpu")
    x = tserial.load_ciphertext(d / "in.npz", device="cpu")
    for k in (1, 2, 4, -1):
        streamed.rotate(x, k)
    store = streamed.rot_keys
    assert store.regen_count == 0 and sorted(store) == sorted(tctx.rot_keys)
    assert store.resident_bytes == sum(
        tctx.rot_keys[k].nbytes for k in tctx.rot_keys) > 1 << 20
    with pytest.raises(KeyError):
        streamed.gen_rotation_keys([3])
    server = tserial.load_eval_context(**paths, device="cpu")
    assert server.keygen is None and server.decryptor is None
    assert sorted(server.rot_keys) == sorted(tctx.rot_keys)
    x = tserial.load_ciphertext(d / "in.npz", device="cpu")
    with pytest.raises(RuntimeError):
        server.decrypt(x)
    with pytest.raises(KeyError):
        server.gen_rotation_keys([3])    # 3 was never serialized
    z = server.fresh_zero(8)
    assert z.data.shape == (2, server.params.nq, server.n)
    assert not z.data.any() and z.scale == server.delta and z.slots == 8
    # the server encrypts with the public key alone
    y = server.encrypt(V, slots=4)
    assert np.abs(tctx.decrypt_debug(y) - V).max() < 1e-8


def _missing_rotations(SortContext, Plain, algo, N=16, ring=1 << 10):
    """Rotation indices the driver's sorter asks for that a minimal key
    set (the bench's, minimal_rotations) lacks, on a key-checking
    PlainContext."""
    ctx = Plain(ring)
    ctx.rot_keys = dict.fromkeys(minimal_rotations(N, ring // 2))
    missing = set()
    plain_rotate = ctx.rotate

    def rotate(ct, k):
        kk = k % ctx.half
        if kk and k % ct.slots and kk not in ctx.rot_keys:
            missing.add(kk)
        return plain_rotate(ct, k)
    ctx.rotate = rotate
    sc = SortContext.__new__(SortContext)
    sc.ctx = ctx
    v = np.linspace(0.05, 0.95, N)[::-1].copy()
    sc.input_ct = ctx.encrypt(v, slots=N)
    out = sc.eval(algo, N, mult_depth=40)
    return missing, ctx.decrypt(out)[:N]


def test_driver_minimal_keys_leave_rotations_uncovered():
    """The composer wraps at N, not at n/2, so the hybrids' ladder
    rotations by -2^i (N-1 = 15 times 2^i) find no key; the direct sort
    finds every one."""
    for algo, missing in (("direct", set()), ("hybrid", {15, 30, 60, 120}),
                          ("hybrid1", {15, 30, 60, 120}),
                          ("hybrid2", {15, 30, 60, 120})):
        jmiss, jout = _missing_rotations(JSortContext, JPlain, algo)
        tmiss, tout = _missing_rotations(TSortContext, TPlain, algo)
        assert tmiss == jmiss == missing, algo
        np.testing.assert_array_equal(tout, jout)


@pytest.mark.slow
@pytest.mark.parametrize("depth", [26, 38])
def test_cli_blind_sort_subprocess(tmp_path, depth):
    """The whole protocol through the port's CLI in a separate process
    (main.cpp:9-44): keys and encryption here, the blind direct sort N=4
    there on the CPU, decryption here.  At tests/test_serial.py's depth
    26 the CLI's fixed sign (4, 3, 3) runs out of levels (it spends 27,
    the registry's (3, 2, 2) at N=4 spends 12, and the registry's direct
    N=4 depth is 23): the server exits with an error.  At 23 + 15 = 38
    the sort is within 0.01."""
    from sorting_fhe_tpu_torch.models.direct_sort import DIRECT_SORT_ROTATIONS
    from sorting_fhe_tpu_torch.utils.testvec import vector_with_min_diff

    N = 4
    ctx = TC(TCfg(ring_dim=1 << 10, mult_depth=depth, scale_bits=52, comp=2,
                  dnum=3), device="cpu")
    ctx.gen_rotation_keys(DIRECT_SORT_ROTATIONS[N])
    paths = tserial.save_eval_material(tmp_path, ctx)
    v = vector_with_min_diff(N, 0, 1, 1.0 / N, np.random.default_rng(3))
    ct_in, ct_out = tmp_path / "in.npz", tmp_path / "out.npz"
    tserial.save_ciphertext(ct_in, ctx.encrypt(v, slots=N))
    res = subprocess.run(
        [sys.executable, "-m", "sorting_fhe_tpu_torch",
         "--cc", paths["cc"], "--key_pub", paths["key_pub"],
         "--key_mult", paths["key_mult"], "--key_rot", paths["key_rot"],
         "--input", str(ct_in), "--output", str(ct_out),
         "--algo", "direct", "--N", str(N), "--cpu"],
        timeout=3000, cwd=REPO, capture_output=True, text=True)
    if depth == 26:
        assert res.returncode != 0
        assert "cannot rescale below base limbs" in res.stderr
        assert not ct_out.exists()
        return
    assert res.returncode == 0, res.stderr
    assert "launches K1=0 K2=0" in res.stderr      # the CPU: no kernel
    got = ctx.decrypt(tserial.load_ciphertext(ct_out, device="cpu"))[:N]
    assert np.abs(got - np.sort(v)).max() < 0.01
