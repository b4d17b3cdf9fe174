"""Smoke run of the torch port on one CUDA GPU: build, check, sort.

    python3 chip_smoke.py

1. Environment: Python/torch/CUDA versions and the card's name and power
   limit (nvidia-smi).  Exits non-zero without a CUDA device: nothing here
   runs on the CPU instead.
2. Build: compiles the NTT kernels (sorting_fhe_tpu_torch/csrc/ntt.cu) with
   nvcc from this checkout's sources and prints the build time.
3. Kernels vs plain versions, on the card, at ring 2^17 on the real
   119-row chain of the hybrid1 N=128 configuration: full prefix, row
   subset [4, 1, 5], leading dim [4, 119, n] and one dynamic row (the
   rescale case).  K1/K2 must be bit-equal to ntt_fwd_t/ntt_inv_t and
   inv(fwd(x)) == x.  Times both with CUDA events.
4. Main path: the port's bench.sort_bench("hybrid1", 128, 17, trials=2) on
   cuda:0, with the kernel launch counters reset just before it.  Requires
   max_err < 0.01, the HEStd-128 security check, and launches of both
   kernels during the run.
5. Prints the kernel record (one JSON line), the card's name and power
   limit, and as the last line {"ok": true, "device": {...}}.  Any failed
   check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import platform
import subprocess
import sys
import time

import numpy as np
import torch

N_SORT = 128
RING_LOG = 17


def _nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int = 5) -> float:
    """Mean device time of fn() over reps launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _residues(rng, primes, lead, n, device) -> torch.Tensor:
    p = np.asarray(primes, dtype=np.uint64).reshape(-1, 1)
    x = rng.integers(0, 1 << 62, size=lead + (len(primes), n),
                     dtype=np.uint64) % p
    return torch.from_numpy(x.astype(np.uint32).view(np.int32)).to(device)


def check_kernels(device) -> tuple[dict, list]:
    """Step 3: bit-equality and times of K1/K2 against the plain versions
    at the main path's shapes.  Returns per-kernel records and a table."""
    from sorting_fhe_tpu_torch.core import cuda_ntt
    from sorting_fhe_tpu_torch.core.ntt import ntt_fwd_t, ntt_inv_t
    from sorting_fhe_tpu_torch.core.params import CkksParams
    from sorting_fhe_tpu_torch.registry import get_params, full_config

    P = CkksParams(full_config(get_params("hybrid1", N_SORT),
                               ring_dim=1 << RING_LOG), device)
    tabs, n, LP = P.ntt, P.n, len(P.all_primes)
    rng = np.random.default_rng(17)
    cases = [
        ("full prefix [119, n]", list(range(LP)), ()),
        ("row subset [4, 1, 5]", [4, 1, 5], ()),
        ("lead dim [4, 119, n]", list(range(LP)), (4,)),
        ("dynamic row [2, 1, n]", [P.nq - 1], (2,)),
    ]
    max_err = {"ntt_fwd": 0, "ntt_inv": 0}
    table = []
    timed = {}
    for name, sel, lead in cases:
        rows = torch.tensor(sel, dtype=torch.int32, device=device)
        r = rows.long()
        x = _residues(rng, [P.all_primes[i] for i in sel], lead, n, device)
        fwd_k = cuda_ntt.ntt_fwd(x, tabs, rows)
        fwd_p = ntt_fwd_t(x, tabs.p[r], tabs.psi[r])
        inv_k = cuda_ntt.ntt_inv(fwd_k, tabs, rows)
        inv_p = ntt_inv_t(fwd_p, tabs.p[r], tabs.ipsi[r], tabs.n_inv[r])
        torch.cuda.synchronize()
        e_f = int((fwd_k.long() - fwd_p.long()).abs().max())
        e_i = int((inv_k.long() - inv_p.long()).abs().max())
        if e_f or e_i or not torch.equal(inv_k, x):
            raise AssertionError(f"{name}: kernel != plain (fwd err {e_f}, "
                                 f"inv err {e_i}, round trip "
                                 f"{torch.equal(inv_k, x)})")
        max_err["ntt_fwd"] = max(max_err["ntt_fwd"], e_f)
        max_err["ntt_inv"] = max(max_err["ntt_inv"], e_i)
        row = {"case": name,
               "fwd_ms": _time_ms(lambda: cuda_ntt.ntt_fwd(x, tabs, rows)),
               "fwd_plain_ms": _time_ms(
                   lambda: ntt_fwd_t(x, tabs.p[r], tabs.psi[r]), 2),
               "inv_ms": _time_ms(lambda: cuda_ntt.ntt_inv(fwd_k, tabs, rows)),
               "inv_plain_ms": _time_ms(
                   lambda: ntt_inv_t(fwd_k, tabs.p[r], tabs.ipsi[r],
                                     tabs.n_inv[r]), 2)}
        table.append(row)
        timed[name] = row
        del x, fwd_k, fwd_p, inv_k, inv_p
    torch.cuda.empty_cache()
    big = timed["lead dim [4, 119, n]"]
    recs = {
        "ntt_fwd": {"name": "ntt_fwd (K1)", "route": "cuda",
                    "source": "sorting_fhe_tpu_torch/csrc/ntt.cu",
                    "replaces": "sorting_fhe_tpu/core/pallas_ntt.py:119",
                    "max_abs_err": max_err["ntt_fwd"],
                    "ms": big["fwd_ms"], "plain_ms": big["fwd_plain_ms"],
                    "shape": "[4, 119, 2^17]"},
        "ntt_inv": {"name": "ntt_inv (K2)", "route": "cuda",
                    "source": "sorting_fhe_tpu_torch/csrc/ntt.cu",
                    "replaces": "sorting_fhe_tpu/core/pallas_ntt.py:151",
                    "max_abs_err": max_err["ntt_inv"],
                    "ms": big["inv_ms"], "plain_ms": big["inv_plain_ms"],
                    "shape": "[4, 119, 2^17]"},
    }
    return recs, table


def main() -> int:
    print(f"python {platform.python_version()} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (this smoke run needs the GPU)",
              file=sys.stderr, flush=True)
        return 1
    card = _nvidia_smi()
    print(f"card: {card}; torch sees {torch.cuda.device_count()} device(s): "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    device = torch.device("cuda:0")

    from sorting_fhe_tpu_torch import bench
    from sorting_fhe_tpu_torch.core import cuda_ntt

    # 2. build
    t0 = time.perf_counter()
    cuda_ntt.build()
    print(f"[build] {cuda_ntt.build_info['path']} in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    for line in cuda_ntt.build_info["ptxas"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}", flush=True)

    # 3. kernels vs plain versions on the card
    recs, table = check_kernels(device)
    for row in table:
        print("[kernel] " + json.dumps(row), flush=True)

    # 4. main path, counting launches from here on
    cuda_ntt.reset_launch_counts()
    rec = bench.sort_bench("hybrid1", N_SORT, RING_LOG, trials=2,
                           device=device)
    launches = {"ntt_fwd": cuda_ntt.ntt_fwd.launches,
                "ntt_inv": cuda_ntt.ntt_inv.launches}
    print("[sort] " + json.dumps(rec), flush=True)
    print(f"[sort] trials {rec['trials']} s, max_err {rec['max_err']:.3e} "
          f"(log2 {np.log2(max(rec['max_err'], 1e-300)):.2f}), "
          f"launches {launches}", flush=True)
    if not (rec["max_err"] is not None and rec["max_err"] < 0.01):
        raise AssertionError(f"sort max_err {rec['max_err']} >= 0.01")
    if not rec["security_ok"]:
        raise AssertionError(f"security check failed: {rec}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"main path never launched {name}")
        recs[name]["launches"] = count

    # 5. results
    print(json.dumps({"kernels": [recs["ntt_fwd"], recs["ntt_inv"]]}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
