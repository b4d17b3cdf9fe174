"""Smoke run of the torch port on one CUDA GPU: build, check, sort.

    python3 chip_smoke.py

1. Environment: Python/torch/CUDA versions and the card's name and power
   limit (nvidia-smi).  Exits non-zero without a CUDA device: nothing here
   runs on the CPU instead.
2. Build: compiles the NTT kernels (sorting_fhe_tpu_torch/csrc/ntt.cu) with
   nvcc from this checkout's sources and prints the build time and the
   registers of each kernel.  When a copy of an earlier version of the
   kernels sits at _chip/prev/ntt.cu (gitignored; e.g. `git show
   <commit>:sorting_fhe_tpu_torch/csrc/ntt.cu`), it is built beside them,
   in parallel, for the timing comparison of step 3 only.
3. Kernels vs plain versions, on the card, at ring 2^17 on the real
   119-row chain of the hybrid1 N=128 configuration, at the main path's
   shape classes ([4, 119, n] decompose, [2, 95, n] moddown/rescale
   forward, [95, n] decompose inverse, [2, 24, n] special primes,
   [2, 1, n] rescale row) plus the full prefix and rows [4, 1, 5].  K1/K2
   must be bit-equal to ntt_fwd_t/ntt_inv_t and inv(fwd(x)) == x.  Prints
   for each kernel and class its launch plan, its time (CUDA events over
   CUDA-graph replays, cycling through enough copies of the input that
   they do not fit the 50 MB L2), its bound (bytes over 3.35 TB/s,
   integer instructions over 132 SMs x 128 per clock x the SM's maximum
   clock) and share of it, the plain version's time and the earlier
   kernels' time in the same call (in turns: earlier, new, new, earlier;
   null without the copy).
4. Main path: the port's bench.sort_bench("hybrid1", 128, 17, trials=2) on
   cuda:0, with the kernel launch counters reset just before it.  Requires
   max_err < 0.01, the HEStd-128 security check, and launches of both
   kernels in every trial.
5. Prints the kernel record (one JSON line), the card's name and power
   limit, and as the last line {"ok": true, "device": {...}}.  Any failed
   check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import ctypes
import json
import platform
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

N_SORT = 128
RING_LOG = 17
BIG = "[4, 119, n] decompose fwd"
PREV_SRC = Path("_chip/prev/ntt.cu")
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
L2_BYTES = 50 * 2**20              # H100 SXM L2
ISSUE_PER_CLOCK = 132 * 4 * 32     # SMs x schedulers x lanes: instructions


def _nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def _nvidia_smi_clock_mhz() -> float:
    """The SM's maximum clock (MHz), for the integer-pipe bound."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(res.stdout.strip().splitlines()[0])


def _time_ms(fn, reps: int = 5) -> float:
    """Mean device time of fn() over reps calls, after one warm-up."""
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


def _kernel_ms(launches, replays: int = 5) -> float:
    """Device time of one launch: max(10, len(launches)) launches, taken
    in turn from `launches` (one per copy of the input), captured in a
    CUDA graph (so the host's enqueue time does not hide in the number),
    replayed once to warm up, then CUDA events around `replays` replays;
    the mean over all the launches replayed."""
    for launch in launches:
        launch()
    torch.cuda.synchronize()
    per_graph = max(10, len(launches))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(per_graph):
            launches[i % len(launches)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (per_graph * replays)


def _residues(rng, primes, lead, n, device) -> torch.Tensor:
    p = np.asarray(primes, dtype=np.uint64).reshape(-1, 1)
    x = rng.integers(0, 1 << 62, size=lead + (len(primes), n),
                     dtype=np.uint64) % p
    return torch.from_numpy(x.astype(np.uint32).view(np.int32)).to(device)


def _start_prev_build():
    """Start nvcc on the earlier kernels' source (PREV_SRC), when a copy
    is there, beside the build of this checkout's kernels."""
    from sorting_fhe_tpu_torch.core import cuda_ntt
    if not PREV_SRC.exists():
        return None
    so = PREV_SRC.parent / "_build" / "libntt_prev.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    cmd = [cuda_ntt._nvcc(), *cuda_ntt.NVCC_FLAGS, "-o", str(so),
           str(PREV_SRC)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True), so


def _load_prev(started):
    """The earlier kernels' library (same C interface), or None."""
    if started is None:
        return None
    proc, so = started
    _, err = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc of {PREV_SRC} failed:\n{err}")
    lib = ctypes.CDLL(str(so))
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ntt_fwd_launch.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, cll, ci,
                                   vp]
    lib.ntt_fwd_launch.restype = ci
    lib.ntt_inv_launch.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ci, ci,
                                   cll, ci, vp]
    lib.ntt_inv_launch.restype = ci
    return lib


def _launches(lib, fwd: bool, pairs, tabs, rows) -> list:
    """Raw launches of K1 (fwd) or K2 of `lib`, one for each (input,
    preallocated output) pair: no wrapper, no allocation, no launch
    count."""
    from sorting_fhe_tpu_torch.core import cuda_ntt
    if fwd:
        fn, tables = lib.ntt_fwd_launch, (tabs.psi, tabs.psi_sh)
    else:
        fn, tables = lib.ntt_inv_launch, (tabs.ipsi, tabs.ipsi_sh,
                                          tabs.n_inv, tabs.n_inv_sh)

    def launcher(x, out):
        def launch():
            err = fn(x.data_ptr(), out.data_ptr(), rows.data_ptr(),
                     tabs.p.data_ptr(), *(t.data_ptr() for t in tables),
                     *cuda_ntt._dims(x, tabs))
            if err:
                raise RuntimeError(f"{fn.__name__} failed: cudaError {err}")
        return launch
    return [launcher(x, out) for x, out in pairs]


def _bound(x, rows, n: int, fwd: bool, int_rate: float) -> dict:
    """Least time of one call: the bytes it must move (input read once,
    output written once, the twiddle and Shoup rows of each distinct
    chain row once) over 3.35 TB/s, and its integer instructions over
    int_rate.  A Shoup butterfly needs 8: umulhi, mul, mad and an add-min
    for the product, an add and an add-min each for the sum and the
    difference (as in the kernels' SASS); K2's n^-1 multiply needs 4."""
    limbs = x.numel() // n
    logn = n.bit_length() - 1
    nbytes = 2 * x.numel() * 4 + 2 * len(set(rows.tolist())) * n * 4
    ops = 8 * limbs * (n // 2) * logn + (0 if fwd else 4 * limbs * n)
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / int_rate * 1e3
    return {"bytes": nbytes, "int_ops": ops, "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def check_kernels(device, int_rate: float, prev) -> tuple[dict, list]:
    """Step 3: bit-equality and times of K1/K2 against the plain versions
    (and the earlier kernels, when built) at the main path's shapes.
    Returns per-kernel records and a table."""
    from sorting_fhe_tpu_torch.core import cuda_ntt
    from sorting_fhe_tpu_torch.core.ntt import ntt_fwd_t, ntt_inv_t
    from sorting_fhe_tpu_torch.core.params import CkksParams
    from sorting_fhe_tpu_torch.registry import get_params, full_config

    P = CkksParams(full_config(get_params("hybrid1", N_SORT),
                               ring_dim=1 << RING_LOG), device)
    tabs, n, LP, nq = P.ntt, P.n, len(P.all_primes), P.nq
    rng = np.random.default_rng(17)
    lib = cuda_ntt.build()
    cases = [   # (name, chain rows, leading dims)
        (BIG, list(range(LP)), (4,)),
        ("[2, 95, n] moddown/rescale fwd", list(range(nq)), (2,)),
        ("[95, n] decompose inv", list(range(nq)), ()),
        ("[2, 24, n] special primes", list(range(nq, LP)), (2,)),
        ("[2, 1, n] rescale row", [nq - 1], (2,)),
        ("[119, n] full prefix", list(range(LP)), ()),
        ("[3, n] rows [4, 1, 5]", [4, 1, 5], ()),
    ]
    max_err = {"ntt_fwd": 0, "ntt_inv": 0}
    table = []
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
        del fwd_p, inv_p
        # copies of the input, so that the timed launches read and write
        # at least twice the L2 and find nothing of their data there
        copies = min(64, -(-L2_BYTES // (x.numel() * 4)))
        row = {"case": name, "shape": list(x.shape[:-1]) + [n],
               "plan": cuda_ntt.launch_plan(x.numel() // n, tabs.logn),
               "copies": copies}
        outs = [torch.empty_like(x) for _ in range(copies)]
        for tag, fwd, src in (("fwd", True, x), ("inv", False, fwd_k)):
            pairs = list(zip([src] + [src.clone()
                                      for _ in range(copies - 1)], outs))
            new = _launches(lib, fwd, pairs, tabs, rows)
            if prev is not None:
                old = _launches(prev, fwd, pairs, tabs, rows)
                old[0]()
                if not torch.equal(outs[0], fwd_k if fwd else x):
                    raise AssertionError(f"{name}: earlier {tag} kernel "
                                         "disagrees")
                # in turns: old, new, new, old
                t_old = _kernel_ms(old)
                t_new = _kernel_ms(new) + _kernel_ms(new)
                t_old = (t_old + _kernel_ms(old)) / 2
                t_new /= 2
            else:
                t_old, t_new = None, _kernel_ms(new)
            if fwd:
                plain = _time_ms(lambda: ntt_fwd_t(src, tabs.p[r],
                                                   tabs.psi[r]), 2)
            else:
                plain = _time_ms(lambda: ntt_inv_t(src, tabs.p[r],
                                                   tabs.ipsi[r],
                                                   tabs.n_inv[r]), 2)
            b = _bound(src, rows, n, fwd, int_rate)
            row[tag] = {"ms": t_new, "prev_ms": t_old, "plain_ms": plain,
                        **b, "share": b["bound_ms"] / t_new}
            del pairs, new
        table.append(row)
        del x, fwd_k, inv_k, outs
    torch.cuda.empty_cache()
    big = table[0]
    recs = {}
    for key, tag, label, line in (("ntt_fwd", "fwd", "ntt_fwd (K1)", 119),
                                  ("ntt_inv", "inv", "ntt_inv (K2)", 151)):
        t = big[tag]
        recs[key] = {"name": label, "route": "cuda",
                     "source": "sorting_fhe_tpu_torch/csrc/ntt.cu",
                     "replaces": f"sorting_fhe_tpu/core/pallas_ntt.py:{line}",
                     "max_abs_err": max_err[key], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": None,
                     "prev_ms": t["prev_ms"], "shape": "[4, 119, 2^17]"}
    return recs, table


def main() -> int:
    print(f"python {platform.python_version()} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (this smoke run needs the GPU)",
              file=sys.stderr, flush=True)
        return 1
    card = _nvidia_smi()
    clock_mhz = _nvidia_smi_clock_mhz()
    int_rate = ISSUE_PER_CLOCK * clock_mhz * 1e6
    print(f"card: {card}; max SM clock {clock_mhz} MHz; torch sees "
          f"{torch.cuda.device_count()} device(s): "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    device = torch.device("cuda:0")

    from sorting_fhe_tpu_torch import bench
    from sorting_fhe_tpu_torch.core import cuda_ntt

    # 2. build (the earlier kernels' nvcc runs alongside)
    t0 = time.perf_counter()
    started = _start_prev_build()
    cuda_ntt.build()
    prev = _load_prev(started)
    print(f"[build] {cuda_ntt.build_info['path']} in "
          f"{time.perf_counter() - t0:.2f}s; earlier kernels: "
          f"{'built' if prev else 'absent'}", flush=True)
    for line in cuda_ntt.build_info["ptxas"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"[build] {line.strip()}", flush=True)

    # 3. kernels vs plain versions on the card
    recs, table = check_kernels(device, int_rate, prev)
    for row in table:
        print("[kernel] " + json.dumps(row), flush=True)

    # 4. main path, counting launches from here on
    cuda_ntt.reset_launch_counts()
    rec = bench.sort_bench("hybrid1", N_SORT, RING_LOG, trials=2,
                           device=device)
    launches = {"ntt_fwd": cuda_ntt.ntt_fwd.launches,
                "ntt_inv": cuda_ntt.ntt_inv.launches}
    brief = {k: rec[k] for k in ("metric", "value", "trials", "max_err",
                                 "security_ok", "device_mem", "phase_s",
                                 "ntt_launches", "device")}
    print("[sort] " + json.dumps(brief), flush=True)
    print(f"[sort] trials {rec['trials']} s, max_err {rec['max_err']:.3e} "
          f"(log2 {np.log2(max(rec['max_err'], 1e-300)):.2f}), "
          f"launches {launches}, op census {rec['op_census'][-1]}",
          flush=True)
    if not (rec["max_err"] is not None and rec["max_err"] < 0.01):
        raise AssertionError(f"sort max_err {rec['max_err']} >= 0.01")
    if not rec["security_ok"]:
        raise AssertionError(f"security check failed: {rec}")
    for name, count in launches.items():
        if count <= 0 or min(t[name] for t in rec["ntt_launches"]) <= 0:
            raise AssertionError(f"main path never launched {name} "
                                 f"(per trial {rec['ntt_launches']})")
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
