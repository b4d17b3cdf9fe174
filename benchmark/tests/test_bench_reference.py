"""The plain reference: its evaluation domain against a direct evaluation,
and its decryption of an output of the port at a small ring, which it
rejects once perturbed."""

import numpy as np
import torch

from benchmark import reference


def test_domain_is_the_direct_evaluation():
    n, p = 16, 97                       # 97 = 1 mod 32
    f = np.random.default_rng(0).integers(0, p, n).astype(np.uint64)
    r = reference.psi(p, n)
    assert pow(r, n, p) == p - 1
    rev = reference.bit_reversal(n)
    direct = [sum(int(f[i]) * pow(r, (2 * int(rev[j]) + 1) * i, p)
                  for i in range(n)) % p for j in range(n)]
    assert reference.to_domain(f, p).tolist() == direct
    assert (reference.from_domain(reference.to_domain(f, p), p) == f).all()


def test_decrypts_a_port_output_and_rejects_a_perturbed_one():
    from sorting_fhe_tpu_torch.core.ckks import CkksContext
    from sorting_fhe_tpu_torch.core.params import CkksConfig
    cfg = CkksConfig(ring_dim=1 << 10, mult_depth=3, scale_bits=52, comp=2,
                     dnum=2, seed=123456789)
    ctx = CkksContext(cfg, device="cpu")
    values = np.random.default_rng(1).uniform(0, 1, 16)
    # a product and a rescale of the port, on its input in sorted order
    out = ctx.rescale(ctx.mult_scalar(ctx.encrypt(np.sort(values),
                                                  slots=16), 0.5))
    data = out.data.numpy().view(np.uint32)
    s = reference.secret_coeffs(ctx.n, cfg.seed)
    got = reference.decode(reference.decrypt(data, cfg_primes(ctx), s),
                           out.scale, 16)
    assert np.abs(got - 0.5 * np.sort(values)).max() < 1e-9
    assert reference.sort_error(data, out.scale, cfg_primes(ctx), s,
                                0.5 * values) < 1e-9
    unsorted = ctx.encrypt(values, slots=16)
    assert reference.sort_error(unsorted.data.numpy().view(np.uint32),
                                unsorted.scale, cfg_primes(ctx), s,
                                values) > 1e-3
    bad = data.copy()
    bad[0, 0, 3] ^= 1 << 20             # one residue altered
    assert reference.sort_error(bad, out.scale, cfg_primes(ctx), s,
                                np.sort(0.5 * values)) > 1e-3
    wrong_key = reference.secret_coeffs(ctx.n, cfg.seed + 1)
    assert reference.sort_error(data, out.scale, cfg_primes(ctx), wrong_key,
                                np.sort(0.5 * values)) > 1e-3
    assert torch.equal(out.data, torch.from_numpy(data.view(np.int32)))


def cfg_primes(ctx):
    return list(ctx.params.q)
