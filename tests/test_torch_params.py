"""CkksParams of the torch port equal the JAX package's: prime chain,
special primes, canonical scales and Montgomery constants, for a cheap
tier and for the full hybrid1 N=128 ring-2^17 configuration."""

from dataclasses import asdict

import numpy as np
import pytest
import torch

from sorting_fhe_tpu.core.params import CkksParams as JParams
from sorting_fhe_tpu import registry as jreg
from sorting_fhe_tpu_torch.core import nt as tnt
from sorting_fhe_tpu_torch.core.params import CkksParams as TParams
from sorting_fhe_tpu_torch import registry as treg

torch.set_num_threads(1)   # one thread per test worker: six share the cores


@pytest.mark.parametrize("tier", ["cheap", "full"])
def test_params_identical(tier):
    jp, tp = jreg.get_params("hybrid1", 128), treg.get_params("hybrid1", 128)
    if tier == "cheap":
        # ring 2^12: the JAX package's prime-pool scan is seconds here,
        # tens of seconds at 2^10 and below
        jcfg, tcfg = jreg.cheap_config(jp, 12), treg.cheap_config(tp, 12)
    else:
        jcfg, tcfg = jreg.full_config(jp), treg.full_config(tp)
    assert asdict(jcfg) == asdict(tcfg)
    J, T = JParams(jcfg), TParams(tcfg, "cpu")
    assert J.q == T.q
    assert J.p_special == T.p_special
    assert (J.alpha, J.num_special, J.base_limbs) == \
        (T.alpha, T.num_special, T.base_limbs)
    assert J.canonical_scale == T.canonical_scale
    np.testing.assert_array_equal(np.asarray(J.mont_neg_p_inv),
                                  T.mont_neg_p_inv.numpy().view(np.uint32))
    rinv = [tnt.mod_inverse((1 << 32) % p, p) for p in T.all_primes]
    assert T.mont_r_inv.tolist() == rinv
    assert jreg.security_check(jcfg, J) == treg.security_check(tcfg, T)
    if tier == "full":
        # the slice's configuration: ring 2^17, depth 46, 95 + 24 primes,
        # dnum 4, HEStd-128 (logQP within 3523)
        assert (T.n, T.nq, T.num_special, tcfg.dnum) == (1 << 17, 95, 24, 4)
        assert treg.security_check(tcfg, T)[2]
