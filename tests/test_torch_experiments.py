"""The experiment harness of the torch port (experiments.py,
utils/memory.py) against the JAX package.

Tier-1 (no encryption):
  * `summarize` writes the JAX package's section line for line, except
    the first-trial note;
  * `MemoryMonitor.report()` has the reference's host keys, and keeps
    them when a device reports: the JAX monitor puts the device's peak
    under the host's `peak_gb`, the port's puts it under `device_peak_gb`.

`slow`: `experiments.run_trial` sorts hybrid1 N=4 at `cheap_config` on
the CPU.

At most two tier-1 tests per file (see tests/test_torch_serial.py).
"""

import pytest
import torch

from sorting_fhe_tpu import experiments as JExp
from sorting_fhe_tpu import registry as jreg
from sorting_fhe_tpu.utils import memory as JMem
from sorting_fhe_tpu_torch import experiments as TExp
from sorting_fhe_tpu_torch import registry as treg
from sorting_fhe_tpu_torch.utils import memory as TMem

torch.set_num_threads(1)   # one thread per test worker: six share the cores

HOST_KEYS = {"idle_gb", "setup_gb", "peak_gb", "average_gb",
             "crypto_overhead_gb", "sorting_overhead_gb"}


def _trial(N, exec_ms, max_err, peak):
    return {"N": N, "ring_dim": 1 << 17, "mult_depth": 46, "scale_bits": 56,
            "sign": (3, 3, 2), "exec_ms": exec_ms, "max_err": max_err,
            "avg_err": max_err / 7, "idle_gb": 0.5, "setup_gb": 3.25,
            "peak_gb": peak, "average_gb": 2.0, "crypto_overhead_gb": 2.75,
            "sorting_overhead_gb": peak - 3.25}


def test_summarize_matches_jax():
    trials = [_trial(128, 6658.0, 2 ** -22.15, 4.5),
              _trial(128, 5666.0, 2 ** -22.3, 4.75),
              _trial(128, 5701.5, 2 ** -21.9, 4.25)]
    for ts in (trials, trials[:1]):
        jl = JExp.summarize(ts).splitlines()
        tl = TExp.summarize(ts).splitlines()
        assert len(tl) == len(jl) == 25
        for j, t in zip(jl, tl):
            if j.startswith("  First Trial"):
                assert t.split("(")[0] == j.split("(")[0]
                assert "cold plaintext encodes" in t
            else:
                assert t == j


def test_memory_report_host_keys(monkeypatch):
    """On the CPU both monitors report the host keys alone.  With a
    device that reports (faked), the JAX report's peak_gb becomes the
    device's; the port's stays the host's."""
    reps = []
    for mem in (JMem, TMem):
        mon = (mem.MemoryMonitor(interval=0.01, device="cpu") if mem is TMem
               else mem.MemoryMonitor(interval=0.01)).start()
        mon.mark("setup")
        mon.stop()
        reps.append(mon.report())
    assert set(reps[0]) == set(reps[1]) == HOST_KEYS
    assert reps[1]["peak_gb"] >= reps[1]["setup_gb"] > 0

    fake = {"in_use_gb": 1.0, "peak_gb": 99.0}
    monkeypatch.setattr(JMem, "device_mem_gb", lambda: dict(fake))
    monkeypatch.setattr(TMem, "device_mem_gb", lambda device: dict(fake))
    monkeypatch.setattr(TMem, "reset_device_peak", lambda device: None)
    jmon = JMem.MemoryMonitor(interval=0.01).start()
    tmon = TMem.MemoryMonitor(interval=0.01, device="cpu").start()
    for mon in (jmon, tmon):
        mon.mark("setup")
        mon.stop()
    jrep, trep = jmon.report(), tmon.report()
    assert jrep["peak_gb"] == 99.0             # the JAX collision
    assert trep["peak_gb"] == tmon.peak_gb < 99.0
    assert {k: trep[k] for k in trep if k.startswith("device_")} == {
        "device_idle_gb": 1.0, "device_setup_gb": 1.0,
        "device_setup_peak_gb": 99.0, "device_peak_gb": 99.0,
        "device_end_gb": 1.0}


@pytest.mark.slow
def test_run_trial_hybrid1_n4_cpu():
    res = TExp.run_trial("hybrid1", 4, 10, seed=100, verbose=False,
                         device="cpu")
    assert res["max_err"] < 0.01 and res["n_big_err"] == 0
    assert res["mult_depth"] == treg.get_params("hybrid1", 4).mult_depth
    assert res["mult_depth"] == jreg.get_params("hybrid1", 4).mult_depth
    assert HOST_KEYS <= set(res) and not any(k.startswith("device_")
                                             for k in res)
    assert res["exec_ms"] > 0 and res["mults"] > 0 and res["rots"] > 0
