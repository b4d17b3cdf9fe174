"""The client/server file protocol of the torch port (serial.py) against
the JAX package's: files cross between the packages both ways.

Tier-1, at tests/test_serial.py's config (ring 2^10, depth 8, comp 2,
dnum 3, rotation keys [1, 2, 4, -1]) and its server ops (square,
rescale, rotate by 1):

  * JAX -> port: files the JAX client writes load in the port bit for
    bit; the port's server and the JAX server compute the same bits on
    them, and the port's output file loads in the JAX loader and
    decrypts on the JAX client within 1e-6; a JAX context file (with
    limb_pad 8) loads as the same config;
  * port -> JAX: files the port's client writes (stored, not deflated)
    load in the JAX loader bit for bit, and the JAX client decrypts the
    port's ciphertext; the port's context file loads in the JAX package
    as the same config less the seed, and a server that builds a client
    from it draws another secret.

`slow`: the JAX server and the port's server on the port client's files
compute the same bits, and each output decrypts on the other package's
client within 1e-6.

Each tier-1 file of this slice holds at most two tests: pytest-xdist's
`--dist loadfile` queues files by test count, and a file with more
tests is handed out before the suite's longer files and can delay them
(tools/xdist_replay.py replays the schedule).
"""

import json
import zipfile

import numpy as np
import pytest
import torch

from sorting_fhe_tpu import serial as jserial
from sorting_fhe_tpu.core.ckks import CkksContext as JC
from sorting_fhe_tpu.core.params import CkksConfig as JCfg
from sorting_fhe_tpu_torch import serial as tserial
from sorting_fhe_tpu_torch.core.ckks import CkksContext as TC
from sorting_fhe_tpu_torch.core.interop import residues_to_numpy
from sorting_fhe_tpu_torch.core.params import CkksConfig as TCfg

torch.set_num_threads(1)   # one thread per test worker: six share the cores

CFG = dict(ring_dim=1 << 10, mult_depth=8, scale_bits=52, comp=2, dnum=3)
# tests/test_serial.py's round-trip config
CFG_B = dict(ring_dim=1 << 12, mult_depth=17, scale_bits=52, comp=2,
             dnum=4, secret_hw=64)
KEYS = [1, 2, 4, -1]
SEED = 918273645          # a client seed other than the config's default
V = np.array([0.1, 0.2, 0.3, 0.4])
WANT = np.roll(V * V, -1)


def _server_op(ctx, x):
    return ctx.rotate(ctx.rescale(ctx.square(x)), 1)


def _bits(ct):
    """uint32 residues of either package's ciphertext, logical limbs."""
    if hasattr(ct.data, "numpy"):
        return residues_to_numpy(ct.data)
    return np.asarray(ct.data)[:, :ct.limbs, :]


@pytest.fixture(scope="module")
def jax_client(tmp_path_factory):
    """JAX client: material and one ciphertext on disk."""
    ctx = JC(JCfg(**CFG))
    ctx.gen_rotation_keys(KEYS)
    d = tmp_path_factory.mktemp("jax_keyring")
    paths = jserial.save_eval_material(d, ctx)
    jserial.save_ciphertext(d / "in.npz", ctx.encrypt(V, slots=4))
    return ctx, paths, d


@pytest.fixture(scope="module")
def port_client(tmp_path_factory):
    """The port's client: material and one ciphertext on disk."""
    ctx = TC(TCfg(**CFG), device="cpu")
    ctx.gen_rotation_keys(KEYS)
    d = tmp_path_factory.mktemp("port_keyring")
    paths = tserial.save_eval_material(d, ctx)
    tserial.save_ciphertext(d / "in.npz", ctx.encrypt(V, slots=4))
    return ctx, paths, d


def _same_material(tserver, paths):
    """The port's evaluation context holds the JAX side's key bits."""
    b, a = jserial.load_public_key(paths["key_pub"])
    np.testing.assert_array_equal(tserver.encryptor.pk[0], b)
    np.testing.assert_array_equal(tserver.encryptor.pk[1], a)
    np.testing.assert_array_equal(residues_to_numpy(tserver.relin_key),
                                  jserial.load_relin_key(
                                      paths["key_mult"]))
    rot, conj = jserial.load_rotation_keys(paths["key_rot"])
    assert conj is None and sorted(rot) == sorted(tserver.rot_keys)
    for k, key in rot.items():
        np.testing.assert_array_equal(residues_to_numpy(tserver.rot_keys[k]),
                                      key)


def test_jax_files_to_port(jax_client, tmp_path):
    """The port's server reads the JAX client's files bit for bit; its
    output file loads in the JAX loader and decrypts on the JAX client.
    A JAX context file with limb bucketing loads as the same config."""
    jctx, paths, d = jax_client
    assert tserial.load_config(paths["cc"]) == TCfg(**CFG)
    jserial.save_context(tmp_path / "j.json", JCfg(**CFG_B, limb_pad=8))
    assert tserial.load_config(tmp_path / "j.json") == TCfg(**CFG_B,
                                                            limb_pad=8)
    tserver = tserial.load_eval_context(**paths, device="cpu")
    _same_material(tserver, paths)
    x = tserial.load_ciphertext(d / "in.npz", device="cpu")
    np.testing.assert_array_equal(_bits(x), _bits(
        jserial.load_ciphertext(d / "in.npz")))
    tout = _server_op(tserver, x)
    jserver = jserial.load_eval_context(**paths)
    jout = _server_op(jserver, jserial.load_ciphertext(d / "in.npz"))
    np.testing.assert_array_equal(_bits(tout), _bits(jout))
    tserial.save_ciphertext(tmp_path / "out.npz", tout)
    back = jserial.load_ciphertext(tmp_path / "out.npz")
    np.testing.assert_array_equal(_bits(back), _bits(tout))
    assert (back.scale, back.noise_deg, back.slots) == \
        (tout.scale, tout.noise_deg, tout.slots)
    assert np.abs(jctx.decrypt(back)[:4] - WANT).max() < 1e-6


def test_port_files_to_jax(jax_client, port_client, tmp_path):
    """The JAX loader reads the port client's files (stored, not
    deflated) bit for bit, and the JAX client, built from the same
    config and seed as the port's client, decrypts the port's
    ciphertext.  The context file leaves out the seed, so a server that
    builds a client from it does not rebuild the client's secret."""
    jctx = jax_client[0]
    tctx, paths, d = port_client
    assert jserial.load_config(paths["cc"]) == JCfg(**CFG)
    tserial.save_context(tmp_path / "t.json", TCfg(**CFG_B, seed=SEED))
    assert "seed" not in json.loads((tmp_path / "t.json").read_text())
    assert jserial.load_config(tmp_path / "t.json") == JCfg(**CFG_B)
    client = TC(TCfg(**CFG, seed=SEED), device="cpu")
    tserial.save_context(tmp_path / "s.json", client.cfg)
    rebuilt = TC(tserial.load_config(tmp_path / "s.json"), device="cpu")
    assert not np.array_equal(rebuilt.keygen.sk.s_coeffs,
                              client.keygen.sk.s_coeffs)
    for name in ("key_pub", "key_mult", "key_rot"):
        with zipfile.ZipFile(paths[name]) as z:
            assert {i.compress_type for i in z.infolist()} == \
                {zipfile.ZIP_STORED}
    _same_material(tctx, paths)
    x = jserial.load_ciphertext(d / "in.npz")
    np.testing.assert_array_equal(_bits(x), _bits(
        tserial.load_ciphertext(d / "in.npz", device="cpu")))
    assert np.abs(jctx.decrypt(x)[:4] - V).max() < 1e-6


@pytest.mark.slow
def test_server_ops_bit_equal_on_port_files(jax_client, port_client,
                                            tmp_path):
    """Each package's server on the port client's files: the same bits,
    and each output decrypts on the other package's client within 1e-6
    (tier-1 compares the servers on the JAX client's files)."""
    _, paths, d = port_client
    tserver = tserial.load_eval_context(**paths, device="cpu")
    jserver = jserial.load_eval_context(**paths)
    tout = _server_op(tserver, tserial.load_ciphertext(d / "in.npz",
                                                       device="cpu"))
    jout = _server_op(jserver, jserial.load_ciphertext(d / "in.npz"))
    np.testing.assert_array_equal(_bits(tout), _bits(jout))
    tserial.save_ciphertext(tmp_path / "t.npz", tout)
    jserial.save_ciphertext(tmp_path / "j.npz", jout)
    got_t = jax_client[0].decrypt(jserial.load_ciphertext(tmp_path / "t.npz"))
    got_j = port_client[0].decrypt(tserial.load_ciphertext(tmp_path / "j.npz",
                                                           device="cpu"))
    for got in (got_t, got_j):
        assert np.abs(got[:4] - WANT).max() < 1e-6


