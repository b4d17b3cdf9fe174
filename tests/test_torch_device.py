"""The port's entry points run on the card unless the caller asks for the
CPU: without a CUDA device they raise, before any table or prime chain is
built, and with device="cpu" they run on the CPU.  No fallback."""

import numpy as np
import pytest
import torch

from sorting_fhe_tpu_torch import registry
from sorting_fhe_tpu_torch.core import nt
from sorting_fhe_tpu_torch.core.ckks import CkksContext
from sorting_fhe_tpu_torch.core.device import resolve_device
from sorting_fhe_tpu_torch.core.interop import keys_to_torch, residues_to_torch
from sorting_fhe_tpu_torch.core.ntt import NttContext
from sorting_fhe_tpu_torch.core.params import CkksConfig, CkksParams

torch.set_num_threads(1)   # one thread per test worker: six share the cores


@pytest.fixture
def no_card(monkeypatch):
    """A machine without a CUDA device, on which building anything fails
    the test: the device is resolved before the chain and the tables."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def built(*args, **kwargs):
        raise AssertionError("built tables before resolving the device")
    monkeypatch.setattr(nt, "find_ntt_primes", built)
    monkeypatch.setattr(nt, "ntt_prime_pool", built)
    monkeypatch.setattr(nt, "make_ntt_tables", built)


def _contexts():
    full = registry.full_config(registry.get_params("hybrid1", 128))
    return [lambda: CkksContext(full), lambda: CkksParams(full),
            lambda: NttContext([12289, 40961], 1 << 8)]


def _interop():
    return [lambda: residues_to_torch(np.zeros((2, 8), np.uint32)),
            lambda: keys_to_torch((np.zeros(2), np.zeros(2)),
                                  np.zeros((2, 8), np.uint32), {}),
            lambda: resolve_device("cuda:0")]


@pytest.mark.parametrize("entry_points", [_contexts, _interop],
                         ids=["contexts", "interop"])
def test_entry_points_default_to_the_card_and_raise_without_one(
        no_card, entry_points):
    for call in entry_points():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


def test_entry_points_run_on_the_cpu_when_asked():
    cfg = CkksConfig(ring_dim=1 << 8, mult_depth=2, scale_bits=28,
                     dnum=2)
    P = CkksParams(cfg, device="cpu")
    assert P.device.type == "cpu" and P.ntt.psi.device.type == "cpu"
    tabs = NttContext(P.q, P.n, "cpu")
    assert torch.equal(tabs.psi, P.ntt.psi[:P.nq])
    x = residues_to_torch(np.arange(16, dtype=np.uint32).reshape(2, 8),
                          "cpu")
    assert x.device.type == "cpu" and x.dtype == torch.int32
    _, relin, rot, conj = keys_to_torch((np.zeros(2), np.zeros(2)),
                                        np.zeros((2, 8), np.uint32),
                                        {3: np.ones((2, 8), np.uint32)},
                                        np.ones((2, 8), np.uint32),
                                        device="cpu")
    assert relin.device.type == "cpu" and rot[3].device.type == "cpu"
    assert conj.device.type == "cpu"
    assert resolve_device("cpu") == torch.device("cpu")
