"""Experiment harness: N-sweep trials with the reference's report format.

Counterpart of sorting_fhe_tpu/experiments.py, a rebuild of the
reference's comparison/run_experiments.sh: loops trials per
(algorithm, size), runs the encrypted sort, scrapes time/error/memory and
aggregates into N{size}_summary.txt + total_results.txt with the exact
section layout of comparison/experimental_results/ours_hybrid1/ (so any
tooling written against the reference's summaries parses ours unchanged).

    python -m sorting_fhe_tpu_torch.experiments --algo hybrid1 \\
        --sizes 4,8,16 --trials 3 --ring 17 --outdir results/ [--cpu]

Per-trial stdout mirrors the reference's gtest log lines
(trials/trial_*/size_*.txt: "Execution time: ... ms", "Maximum error: ...",
"Peak Memory (GB): ...") so run_experiments.sh-style grepping works too.
The memory lines are the host's (utils/memory.py); on the card each
trial's record also holds the device memory of its phases (device_*).

Runs on the card unless --cpu (device="cpu") asks for the CPU.  The
streaming arm is the JAX harness's (mehp24 N >= 32, bitonic, k-way, or
N >= 256, at ring >= 2^16): such a sort streams its rotation keys under
SORTING_FHE_KEY_BUDGET_MB, e.g.

    SORTING_FHE_KEY_BUDGET_MB=5120 python -m sorting_fhe_tpu_torch.experiments \\
        --algo mehp24 --sizes 512 --trials 1

and each trial's record gives the keys, their regenerations and the
bytes resident after the sort (beside the sort's NTT kernel launches,
which include the launches of the keys it made).  Where it differs from
the JAX package's harness: without the variable every key stays
resident (the JAX arm's default of 5120 MB is sized for the 16 GB v5e;
see bench.key_budget_overrides), nothing is pre-touched, k-way boots
against the registry's depth (the JAX harness's KWaySorter takes half
the chain's), and mehp24 takes the bench's degrees (bench.mehp24_degrees,
the reference fixture's).  The sorters, their keys and the sparse
secret of the sorts that boot are bench.build_sorter's and
bench.boot_overrides', so the harness and the bench build the same
sort; bitonic's and k-way's bootstrap keys are made in the setup.
"""

from __future__ import annotations

import argparse
import gc
import os
import sys
import time

import numpy as np

from .bench import (boot_overrides, build_sorter, default_minimal_keys,
                    key_budget_overrides)
from .core.cuda_ntt import ntt_fwd, ntt_inv
from .registry import get_params, full_config, cheap_config, security_check
from .utils.memory import MemoryMonitor
from .utils.testvec import vector_with_min_diff


def _release(ctx):
    """Drop a context's keys and caches (device memory) eagerly."""
    ctx.rot_keys.clear()
    ctx._pt_cache.clear()
    ctx._pt_cache_bytes = 0
    ctx._pt_host_cache.clear()
    ctx._pt_host_bytes = 0
    ctx._tables.clear()


def run_trial(algo: str, N: int, ring_log: int, seed: int,
              verbose: bool = True, reuse=None, device="cuda") -> dict:
    """One encrypted sort on `device`; returns time/error/memory like one
    trials/trial_*/size_*.txt of the reference.

    reuse: optional dict carrying (ctx, sort_fn, slots) across trials of one
    size.  The reference's 10-trial protocol re-runs the gtest binary
    (fresh context every trial) but its recorded Execution time covers
    the sort only — context reuse keeps that measurement semantics while
    cutting the per-trial keygen."""
    from .core.ckks import CkksContext

    p = get_params(algo if algo != "direct2n" else "direct", N)
    boot = boot_overrides(algo)
    boot.update(key_budget_overrides(ring_log >= 16 and (
        (algo == "mehp24" and N >= 32) or algo in ("bitonic", "kway")
        or N >= 256)))
    cfg = (full_config(p, **boot) if ring_log >= 16
           else cheap_config(p, ring_log=ring_log, **boot))
    mon = MemoryMonitor(device=device).start()
    t0 = time.time()
    if reuse is not None and "ctx" in reuse:
        ctx, sort_fn, slots = reuse["ctx"], reuse["sort_fn"], reuse["slots"]
    else:
        ctx = CkksContext(cfg, device=device)
        sort_fn, slots, _ = build_sorter(
            ctx, algo, N, p, minimal_keys=default_minimal_keys(N, ring_log))
        if reuse is not None:
            reuse.update(ctx=ctx, sort_fn=sort_fn, slots=slots)
    rng = np.random.default_rng(seed)
    v = vector_with_min_diff(N, 0, 1, 1.0 / N, rng)
    ct = ctx.encrypt(v, slots=slots)
    ctx.sync()
    setup_s = time.time() - t0
    mon.mark("setup")

    m0, r0 = ctx.mult_count, ctx.rot_count
    k0 = [kern.launches for kern in (ntt_fwd, ntt_inv)]
    t0 = time.time()
    out = sort_fn(ct, p.sign_config())
    ctx.sync()
    exec_ms = (time.time() - t0) * 1000.0
    launches = {kern.__name__: kern.launches - n0
                for kern, n0 in zip((ntt_fwd, ntt_inv), k0)}
    got = ctx.decrypt(out)[:N]
    mon.stop()

    err = np.abs(got - np.sort(v))
    max_err = float(err.max())
    avg_err = float(err.mean())
    mem = mon.report()
    logqp, limit, sec_ok = security_check(cfg, ctx.params)
    counts = (ctx.mult_count - m0, ctx.rot_count - r0)
    # len() and resident_bytes make no key (items() would make them all)
    keys = {"rot_keys": len(ctx.rot_keys),
            "key_budget_mb": cfg.rot_key_budget_mb,
            "key_regens": ctx.rot_keys.regen_count,
            "rot_keys_resident_bytes": ctx.rot_keys.resident_bytes}
    if reuse is None:
        # release this trial's device memory eagerly: a lingering
        # previous context would crowd the next trial
        _release(ctx)
        del sort_fn, ct, out, ctx
    else:
        # trial-boundary trim: the device plaintext cache refills cheaply
        # from the host row cache
        ctx._pt_cache.clear()
        ctx._pt_cache_bytes = 0
        del ct, out
    gc.collect()
    res = {
        "algo": algo, "N": N, "ring_dim": cfg.ring_dim,
        "mult_depth": cfg.mult_depth, "scale_bits": cfg.scale_bits,
        "sign": p.sign or (3, 2, 2),
        "setup_s": setup_s, "exec_ms": exec_ms,
        "max_err": max_err, "avg_err": avg_err,
        "n_big_err": int((err > 0.01).sum()),
        "mults": counts[0], "rots": counts[1],
        "logqp": logqp, "sec_ok": sec_ok, **keys, "ntt_launches": launches,
        **mem,
    }
    if verbose:
        # the reference's gtest stdout lines (size_*.txt), greppable
        print(f"Input array size: {N}")
        print(f"Using Ring Dimension: {cfg.ring_dim}")
        print(f"Multiplicative depth: {cfg.mult_depth}")
        print(f"Scaling Mod: {cfg.scale_bits}")
        n_, dg_, df_ = res["sign"]
        print(f"Sign Configuration: CompositeSign({n_}, {dg_}, {df_})")
        print()
        print("Performance Analysis:")
        print(f"Execution time: {exec_ms:.0f} ms")
        print()
        print("Memory Analysis:")
        print(f"Idle Memory (GB): {mem['idle_gb']:.6g}")
        print(f"Setup Memory (GB): {mem['setup_gb']:.6g}")
        print(f"Peak Memory (GB): {mem['peak_gb']:.6g}")
        print(f"Average Memory (GB): {mem['average_gb']:.6g}")
        print(f"Crypto Overhead (GB): {mem['crypto_overhead_gb']:.6g}")
        print(f"Sorting Overhead (GB): {mem['sorting_overhead_gb']:.6g}")
        print()
        print("Error Analysis:")
        print(f"Maximum error: {max_err:.6g} "
              f"(log2: {np.log2(max(max_err, 1e-300)):.4f})")
        print(f"Average error: {avg_err:.6g} "
              f"(log2: {np.log2(max(avg_err, 1e-300)):.4f})")
        print(f"Number of errors larger than 0.01: {res['n_big_err']}")
        sys.stdout.flush()
    return res


def summarize(trials: list[dict]) -> str:
    """The reference's total_results.txt section for one N.

    With >1 trial the Average Time is the STEADY-STATE mean (trial 1
    excluded): the first trial of a context encodes every plaintext mask
    on the host (cold caches), and is reported separately as First
    Trial."""
    t = trials[0]
    steady = trials[1:] if len(trials) > 1 else trials
    avg_time = np.mean([x["exec_ms"] for x in steady]) / 1000.0
    first_time = trials[0]["exec_ms"] / 1000.0
    n_, dg_, df_ = t["sign"]
    lines = [
        "=" * 38,
        f"     Results for N = {t['N']}",
        "=" * 38,
        "Crypto Parameters:",
        f"  Ring Dimension      : {t['ring_dim']}",
        f"  Multiplicative Depth: {t['mult_depth']}",
        f"  Scaling Mod Size    : {t['scale_bits']}",
        f"  Sign Configuration  : CompositeSign({n_}, {dg_}, {df_})",
        "",
        "Performance Metrics:",
        f"  Average Time     : {avg_time:.4f}s",
        f"  First Trial      : {first_time:.4f}s  "
        "(includes cold plaintext encodes)",
        "",
        "Memory Metrics:",
        f"  Idle Memory        : {np.mean([x['idle_gb'] for x in trials]):.4f} GB",
        f"  Setup Memory       : {np.mean([x['setup_gb'] for x in trials]):.4f} GB",
        f"  Peak Memory        : {np.mean([x['peak_gb'] for x in trials]):.4f} GB",
        f"  Average Memory     : {np.mean([x['average_gb'] for x in trials]):.4f} GB",
        f"  Crypto Overhead    : {np.mean([x['crypto_overhead_gb'] for x in trials]):.4f} GB",
        f"  Sorting Overhead   : {np.mean([x['sorting_overhead_gb'] for x in trials]):.4f} GB",
        "",
        "Error Analysis:",
        f"  Max Error (log2): "
        f"{np.mean([np.log2(max(x['max_err'], 1e-300)) for x in trials]):.4f}",
        f"  Average Error (log2): "
        f"{np.mean([np.log2(max(x['avg_err'], 1e-300)) for x in trials]):.4f}",
        "=" * 38,
        "",
    ]
    return "\n".join(lines)


def main(argv=None) -> list[list[dict]]:
    """Run the sweep; returns each size's trial records."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--algo", default="hybrid1")
    ap.add_argument("--sizes", default="4,8,16",
                    help="comma-separated array sizes")
    ap.add_argument("--trials", type=int, default=1)
    ap.add_argument("--ring", type=int, default=17,
                    help="log2 ring dimension (>=16 selects the "
                         "full-fidelity registry tier)")
    ap.add_argument("--outdir", default="experimental_results")
    ap.add_argument("--reuse-context", action="store_true",
                    help="build context/keys once per size and reuse "
                         "across trials (exec-time semantics match the "
                         "reference's per-trial records)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    sizes = [int(s) for s in args.sizes.split(",")]
    os.makedirs(args.outdir, exist_ok=True)
    total, records = [], []
    for N in sizes:
        trials = []
        reuse = {} if args.reuse_context else None
        for t in range(args.trials):
            print(f"--- {args.algo} N={N} trial {t + 1}/{args.trials} ---")
            trials.append(run_trial(args.algo, N, args.ring, seed=100 + t,
                                    reuse=reuse, device=device))
        if reuse and "ctx" in reuse:
            _release(reuse.pop("ctx"))
            reuse.clear()
            gc.collect()
        block = summarize(trials)
        with open(os.path.join(args.outdir, f"N{N}_summary.txt"), "w") as f:
            f.write(block)
        total.append(block)
        records.append(trials)
        print(block)
    with open(os.path.join(args.outdir, "total_results.txt"), "w") as f:
        f.write("\n".join(total))
    return records


if __name__ == "__main__":
    main()
