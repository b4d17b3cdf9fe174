"""Encrypted-sort benchmark of the torch port (direct family, MEHP24,
bitonic and k-way).

Counterpart of the repository's bench.py `sort_bench`: build the
depth-matched full-fidelity context for (algo, N) from the registry,
generate keys, encrypt one test vector, run the sort `trials` times and
check the first result against np.sort.  The record has the JAX bench's
keys plus the peak device memory of each phase (setup, keys, encrypt,
sort) from torch.cuda.max_memory_allocated, the resident key set, the op
census, the plaintext encodes and the NTT kernel launches of each trial,
and the device it ran on.  Every rotation key stays resident unless
SORTING_FHE_KEY_BUDGET_MB sets a budget (key_budget_overrides; then the
record counts the keys' regenerations).  Bitonic and k-way bootstrap
mid-sort (core/bootstrap.py, a
sparse secret of Hamming weight 64): the bootstrap keys of the sort's
slot width are made in the keys phase, and the record gives each trial's
bootstraps (seconds, phases, limbs before and after).

    python -m sorting_fhe_tpu_torch.bench [algo] [N] [ring_log] [trials] [k]

(k: the k-way network's k, default 2, N = k^M.)  It
prints one JSON record on stdout; it needs a CUDA device (on any other
device it exits non-zero: a CPU time is not a result of this benchmark).
With BENCH_PROFILE=<dir> the last trial runs under torch.profiler: the
record gains a device-time breakdown by kernel and the chrome trace goes
to <dir>.  The JAX harness's switches, after the sort: BENCH_MICRO=1
adds the per-op table at the context's top level (`micro_bench`) to the
record as "micro"; BENCH_NTT=1 adds K1's throughput on 64 limbs
(`ntt_bench`) as "ntt"; BENCH_SORT=0 runs only that and prints its
record.  A failure in either raises: nothing is logged and passed over.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

from .core.ckks import KEY_BUDGET_ENV
from .utils.memory import device_mem_gb, reset_device_peak

# Reference hybrid1 averages: OpenFHE on a CPU, ring 2^17, HEStd_128_classic,
# average of 10 trials (BASELINE.md table; seconds)
BASELINE_HYBRID1 = {4: 26.69, 8: 36.25, 16: 37.03, 32: 52.14, 64: 56.93,
                    128: 74.12, 256: 93.53, 512: 178.87, 1024: 406.93}
ALGOS = ("direct", "hybrid", "hybrid1", "hybrid2", "mehp24", "bitonic",
         "kway")
# bitonic's data and gate are its reference fixture's
# (tests/test_bootstrap_depth.py: BitonicSortTest.cpp:20-72, 88-103):
# values in [0, 255] at least 0.01 apart; max error < 1.0 and no slot off
# by more than 0.1.  Every other sort: [0, 1], gap 1/N, max error < 0.01.
BITONIC_GATE = (1.0, 0.1)
GATE = 0.01


def mehp24_degrees(p) -> tuple[int, int, int, int]:
    """sort_fg's (dg_c, df_c, dg_i, df_i) for the registry's SortParams p,
    as the reference's Mehp24SortTest.cpp:126-137 sets them: the
    comparison's from the sign ladder, the indicator's dg_i =
    (log2 N + 1) // 2 with df_i = 2.  The JAX package's bench.py takes
    dg_i = dg_c, which at N=128 (dg 3) misses the 0.01 gate even in exact
    arithmetic (a gap of 0.017 from np.sort); this choice uses 42 of the
    43 levels that the registry gives mehp24 N=128."""
    c = p.sign_config().compos
    return c.dg, c.df, (int(np.log2(p.N)) + 1) // 2, 2


def boot_overrides(algo: str) -> dict:
    """Config overrides of a sort: bitonic and k-way bootstrap mid-sort,
    and a sparse secret keeps the mod-raise integer within EvalMod's
    sine range (bench.py:277-279)."""
    return {"secret_hw": 64} if algo in ("bitonic", "kway") else {}


def key_budget_overrides(streams: bool) -> dict:
    """Config overrides of the JAX harnesses' streaming arm (bench.py:
    279-283, experiments.py:90-100), `streams` being the arm's condition
    for the sort: the rotation keys' budget in MB from
    SORTING_FHE_KEY_BUDGET_MB.  The JAX arms default to 5120 MB, sized
    for the 16 GB v5e; here the arm applies a budget only when the
    variable is set, because every key set of the registry fits the
    H100's 80 GB (the largest, mehp24 N=512, 40.9 GB) and a default would
    turn resident runs such as mehp24 N=128 into streamed ones.
    (CkksContext reads the same variable for a config without a budget;
    the arm writes it into the config.)"""
    env = os.environ.get(KEY_BUDGET_ENV)
    return {"rot_key_budget_mb": int(env)} if streams and env else {}


def default_minimal_keys(N: int, ring_log: int) -> bool:
    """Compose rotations from the pow-2 ladder at N >= 32 on a
    full-fidelity ring, as the JAX bench does."""
    return ring_log >= 16 and N >= 32


def build_sorter(ctx, algo: str, N: int, p, minimal_keys: bool = False,
                 hook=None, k: int | None = None):
    """(sort_fn(ct, sign_cfg) -> ct, slots, key mode) of the (algo, N)
    sort on `ctx` for the registry's SortParams `p`, its keys made.  The
    sorts that boot use `hook` (default BootstrapHook(ctx)), whose keys
    of the sort's slot width are made here too; `k` is the k-way
    network's k (default: kway_factorization's)."""
    from .core.bootstrap import BootstrapHook
    from .models import mehp24 as M24
    from .models.bitonic import BitonicSort
    from .models.direct_sort import DirectSort
    from .models.kway import KWaySorter, kway_factorization

    if algo in ("bitonic", "kway") and hook is None:
        hook = BootstrapHook(ctx)
    slots = N
    if algo == "bitonic":
        # boots when more than 29 levels are consumed (sort_algo.h:1436)
        sort_fn = BitonicSort(ctx, N, rot_indices=list(p.rotations),
                              bootstrap_level=29, bootstrap_hook=hook).sort
        key_mode = "bitonic network + bootstrap"
    elif algo == "kway":
        if k is None:
            k, M = kway_factorization(N)
        else:
            M = round(np.log(N) / np.log(k))
        # checkLevelAndBoot against the chain's depth (EvalUtils.cpp:57-86)
        ks = KWaySorter(ctx, k, M, mult_depth=p.mult_depth,
                        bootstrap_hook=hook)
        sort_fn, slots = ks.sort, ks.num_slots
        key_mode = "k-way network + bootstrap"
    elif algo == "mehp24":
        degrees = mehp24_degrees(p)
        if N > 256:
            sort_fn = lambda ct, sign_cfg: M24.sort_large_array_fg(
                ctx, ct, N, 256, *degrees)
            slots = 256 * 256
        else:
            # the matrix ladders' keys (rotation_indices), made here
            # rather than in the first sort
            M24.Mehp24(ctx, N)
            sort_fn = lambda ct, sign_cfg: M24.sort_fg(ctx, ct, N, *degrees)
            slots = N * N  # the N x N comparison matrix in one ciphertext
        key_mode = "mehp24 ladders"
    elif algo in ("direct", "direct2n", "hybrid", "hybrid1", "hybrid2"):
        ds = DirectSort(ctx, N, rot_indices=list(p.rotations),
                        use_minimal_keys=minimal_keys)
        sort_fn = {"direct": ds.sort, "direct2n": ds.sort_2n,
                   "hybrid": ds.sort_hybrid, "hybrid1": ds.sort_hybrid1,
                   "hybrid2": ds.sort_hybrid2}[algo]
        key_mode = "minimal" if minimal_keys else "registry"
    else:
        raise ValueError(f"unknown algorithm {algo!r}")
    if hook is not None:
        hook.setup(slots)
    return sort_fn, slots, key_mode


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _elapsed_ms(fn, device: torch.device) -> float:
    """Milliseconds of fn(): CUDA events around it on the card (what the
    device's stream takes, host launch gaps included), the host clock on
    any other device."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    with torch.cuda.device(device):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)


def _marginal_ms(body, data, device: torch.device, lo: int, hi: int
                 ) -> tuple[float, dict]:
    """Milliseconds per call of `body` chained on `data` (a = body(a)),
    as the JAX harness differences two fori_loop repetition counts:
    (t(hi) - t(lo)) / (hi - lo), so that a fixed cost per run cancels.
    Each count runs once to warm up and once timed.  Returns that and
    the timed runs' milliseconds by count."""
    def run():
        a = data
        for _ in range(reps):
            a = body(a)
    for reps in (lo, hi):
        run()
    ts = {}
    for reps in (lo, hi):
        ts[reps] = _elapsed_ms(run, device)
    return (ts[hi] - ts[lo]) / (hi - lo), ts


def ntt_bench(ring_log: int, device="cuda") -> dict:
    """K1's throughput at ring 2^ring_log (bench.py:102-149): 64 30-bit
    primes, one [1, 64, n] poly of residues from default_rng(0), rows
    0..63, through cuda_ntt.ntt_fwd (the hand-written kernel on the card,
    its plain version only on a CPU tensor).  Seconds per call from 4 and
    24 back-to-back calls, differenced (_marginal_ms)."""
    from .core import nt
    from .core.cuda_ntt import ntt_fwd
    from .core.device import resolve_device
    from .core.interop import residues_to_torch
    from .core.ntt import NttContext

    device = resolve_device(device)
    n, L = 1 << ring_log, 64
    # 30-bit primes: dense enough (= 1 mod 2n) at every ring up to 2^17
    primes = nt.find_ntt_primes(30, L, n)
    tabs = NttContext(primes, n, device)
    rng = np.random.default_rng(0)
    x = residues_to_torch(np.stack([
        rng.integers(0, p, size=n, dtype=np.uint64).astype(np.uint32)
        for p in primes]).reshape(1, L, n), device)
    rows = torch.arange(L, dtype=torch.int32, device=device)
    k_lo, k_hi = 4, 24
    t0 = time.time()
    ms, ts = _marginal_ms(lambda y: ntt_fwd(y, tabs, rows), x, device,
                          k_lo, k_hi)
    rate = L / (ms / 1e3)
    log(f"[ntt] {rate:,.0f} limb-NTTs/s at n=2^{ring_log} "
        f"({ms:.4f} ms per {L}-limb poly; T{k_lo}={ts[k_lo]:.3f}ms "
        f"T{k_hi}={ts[k_hi]:.3f}ms; {time.time() - t0:.1f}s in all)")
    return {"metric": f"ntt_limb_transforms_per_s_ring2e{ring_log}",
            "value": round(rate, 1), "unit": "1/s", "vs_baseline": None}


def micro_bodies(ctx, l: int, relin_key, rot_key, perm) -> dict:
    """The micro table's op bodies at limb count l (bench.py:185-219), by
    name: each maps [2, l, n] int32 data to data of that shape, so that
    it chains.  mult_relin squares with the relinearisation key; rescale
    drops `comp` rows and pads them back with zeros; hoist_precompute
    writes the first digit's q rows of decompose(a[1]) into a[0];
    rot_composed_m / rot_hoisted_m are m fast rotations with `rot_key`
    and `perm`, after a decompose each or after one."""
    from .core.ckks import (_kj_decompose, _kj_fast_rotate, _kj_mult_relin,
                            _kj_rescale)
    T, comp = ctx.tables(l), ctx.params.comp
    steps = ctx._rescale_consts(l)
    pad = torch.zeros((2, comp, ctx.n), dtype=torch.int32, device=ctx.device)

    def rot_chain(m: int, hoisted: bool):
        def body(a):
            pre = _kj_decompose(a[1], T)
            for i in range(m):
                if i and not hoisted:
                    pre = _kj_decompose(a[1], T)
                a = _kj_fast_rotate(a, pre, rot_key, perm, T)
            return a
        return body

    bodies = {
        "mult_relin": lambda a: _kj_mult_relin(a, a, relin_key, T),
        "rescale": lambda a: torch.cat(
            [_kj_rescale(a, steps, T)[:, :l - comp], pad], dim=1),
        "hoist_precompute": lambda a: torch.stack(
            (_kj_decompose(a[1], T)[0, :l], a[1]))}
    for m in (1, 4):
        bodies[f"rot_composed_{m}"] = rot_chain(m, False)
        bodies[f"rot_hoisted_{m}"] = rot_chain(m, True)
    return bodies


def micro_bench(ctx, limbs: int | None = None) -> dict:
    """Per-op milliseconds at the context's top level (bench.py:152-234):
    mult_relin, rescale and the hoisting precompute (repetitions 2 and 8),
    composed against hoisted rotation chains of 1 and 4 steps (1 and 3;
    the reference's RotationBenchmark.cpp:8-53), each the op as the port
    issues it (_marginal_ms: CUDA events on the card, host launch gaps
    included; the host clock on the CPU), and the host's ns per
    evaluation of Sinc(128)'s scaled and doubled sinc
    (SincBenchmark.cpp:15-35).  The data is [2, l, n] residues drawn per
    prime from default_rng(0); rotation key 1 is the key store's (made
    under a budget).  Returns the JAX function's 8 keys, rounded to 3
    places."""
    from .ops.comparison import Sinc

    P = ctx.params
    l = limbs or P.nq
    ctx.gen_rotation_keys([1])
    rk, perm = ctx._key(1), ctx._perm(1)
    rng = np.random.default_rng(0)
    data = torch.from_numpy(np.ascontiguousarray(np.stack([
        rng.integers(0, P.q[i], size=(2, ctx.n), dtype=np.int64
                     ).astype(np.uint32) for i in range(l)], axis=1)
    ).view(np.int32)).to(ctx.device)
    bodies = micro_bodies(ctx, l, ctx.relin_key, rk, perm)
    out = {}
    for name, body in bodies.items():
        lo, hi = (1, 3) if name.startswith("rot_") else (2, 8)
        out[f"{name}_ms"] = _marginal_ms(body, data, ctx.device, lo, hi)[0]

    sk = Sinc(128)
    xs = np.linspace(-1, 1, 1 << 12)
    t0 = time.perf_counter()
    for x in xs:
        sk.scaled_sinc(x)
        sk.doubled_sinc(x)
    out["sinc_host_ns_per_eval"] = \
        (time.perf_counter() - t0) / (2 * len(xs)) * 1e9
    log(f"[micro] limbs={l}: " + "  ".join(
        f"{k}={v:.2f}" for k, v in out.items()))
    return {k: round(v, 3) for k, v in out.items()}


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mem_gb(device: torch.device) -> dict:
    """Peak and current allocated device memory since the last reset, in
    GB (10^9 bytes); empty off CUDA."""
    return device_mem_gb(device, unit=1e9)


def resident_gb(ctx) -> dict:
    """Accounted resident working set: keys, NTT tables, plaintext cache."""
    ntt = ctx.params.ntt
    out = {
        "rot_keys_gb": ctx.rot_keys.resident_bytes / 1e9,
        "relin_key_gb": ctx.relin_key.nbytes / 1e9,
        "conj_key_gb": (0 if ctx.conj_key is None
                        else ctx.conj_key.nbytes) / 1e9,
        "ntt_tables_gb": sum(getattr(ntt, nm).nbytes for nm in
                             ("psi", "psi_sh", "ipsi", "ipsi_sh")) / 1e9,
        "pt_cache_gb": ctx._pt_cache_bytes / 1e9,
    }
    out["total_gb"] = sum(out.values())
    return out


# device kernels by class, first match of a substring of the kernel name
KERNEL_CLASSES = (("ntt", ("chunk_pass", "col_pass")),
                  ("copy", ("copy", "Copy")),
                  ("gather", ("gather", "index")),
                  ("int64 element-wise", ("long",)))


def _kernel_class(name: str) -> str:
    for cls, keys in KERNEL_CLASSES:
        if any(k in name for k in keys):
            return cls
    return "other"


def profile_summary(prof, wall_s: float, top: int = 25) -> dict:
    """Device time by kernel name and by class (KERNEL_CLASSES: the NTT
    kernels; copies and casts; gathers; the remaining kernels on int64
    tensors, the residue arithmetic of the base conversions, rescale and
    the other ops) from a finished torch.profiler run, and the device's
    busy and idle share of the trial's wall time (one stream: kernels do
    not overlap).  The top 25 names reach the NTT kernels' four entries
    (two passes each), which a top 15 would cut off."""
    from torch.autograd import DeviceType
    us, count = collections.Counter(), collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us[e.name] += e.time_range.elapsed_us()
            count[e.name] += 1
    busy = sum(us.values()) / 1e6
    if not us:
        return {"device_time": "not measured (no device events traced)"}
    by_class = collections.defaultdict(lambda: {"s": 0.0, "count": 0})
    for k, v in us.items():
        c = by_class[_kernel_class(k)]
        c["s"] += v / 1e6
        c["count"] += count[k]
    for c in by_class.values():
        c["share"] = c["s"] / busy
    return {"wall_s": wall_s, "device_busy_s": busy,
            "device_idle_share": 1.0 - busy / wall_s,
            "kernels": sum(count.values()), "by_class": dict(by_class),
            "top": [{"name": k[:120], "s": v / 1e6, "share": v / 1e6 / busy,
                     "count": count[k]} for k, v in us.most_common(top)]}


class TimedHook:
    """A bootstrap hook that records each call: slot width, limbs before
    and after, seconds (device synchronised) and the phases' seconds
    (Bootstrapper.phase_s)."""

    def __init__(self, hook):
        self.hook = hook
        self.calls: list[dict] = []

    def setup(self, slots: int):
        return self.hook.setup(slots)

    def __call__(self, ct):
        ctx = self.hook.ctx
        ctx.sync()
        t0 = time.time()
        out = self.hook(ct)
        ctx.sync()
        self.calls.append({
            "slots": ct.slots, "limbs_in": ct.limbs, "limbs_out": out.limbs,
            "s": time.time() - t0,
            "phase_s": dict(self.hook.setup(ct.slots).phase_s)})
        return out


def sort_bench(algo: str, N: int, ring_log: int, trials: int,
               device="cuda", seed: int = 42,
               profile_dir: str | None = None, k: int = 2,
               keep: dict | None = None) -> dict:
    """Run the (algo, N) encrypted sort at ring 2^ring_log on `device`;
    with `profile_dir`, trace the last trial (see profile_summary).  `k`
    is the k-way network's k (N = k^M).  `keep`, a dict, receives what a
    caller needs to run the same sort again: the context ("ctx"), the
    input ("ct") and its values ("values"), the first trial's output
    ("out"), the sign config ("sign"), the registry's SortParams
    ("params") and the slot count ("slots")."""
    from .core import cuda_ntt
    from .core.bootstrap import BootstrapHook
    from .core.ckks import CkksContext
    from .registry import get_params, full_config, security_check
    from .utils.testvec import vector_with_min_diff

    if algo not in ALGOS:
        raise KeyError(f"not ported: {algo!r} (ported: {ALGOS})")
    if algo == "mehp24" and N > 256:
        raise KeyError("mehp24 N > 256 sorts through sort_large_array_fg, "
                       "which this bench does not drive")
    if algo == "kway" and k ** round(np.log(N) / np.log(k)) != N:
        raise ValueError(f"kway: N={N} is not a power of k={k}")
    device = torch.device(device)
    p = get_params(algo, N)
    boots = algo in ("bitonic", "kway")
    cfg = full_config(p, ring_dim=1 << ring_log, **boot_overrides(algo),
                      **key_budget_overrides(
                          algo == "mehp24" and ring_log >= 16 and N >= 32))
    mem, secs = {}, {}

    reset_device_peak(device)
    t0 = time.time()
    ctx = CkksContext(cfg, device=device)
    _sync(device)
    secs["setup"], mem["setup"] = time.time() - t0, _mem_gb(device)
    logqp, limit, ok = security_check(cfg, ctx.params)
    log(f"[setup] context {secs['setup']:.1f}s: {ctx.params.describe()} "
        f"device={device} security logQP={logqp} limit={limit} ok={ok}")

    reset_device_peak(device)
    t0 = time.time()
    hook = TimedHook(BootstrapHook(ctx)) if boots else None
    # BENCH_KEYS=minimal|registry overrides the direct family's key mode
    minimal = os.environ.get("BENCH_KEYS", "minimal" if default_minimal_keys(
        N, ring_log) else "registry") == "minimal"
    sort_fn, slots, key_mode = build_sorter(ctx, algo, N, p,
                                            minimal_keys=minimal, hook=hook,
                                            k=k)
    _sync(device)
    secs["keys"], mem["keys"] = time.time() - t0, _mem_gb(device)
    log(f"[setup] rotation keys ({len(ctx.rot_keys)}, {key_mode}) "
        f"{secs['keys']:.1f}s {mem['keys']}")

    rng = np.random.default_rng(seed)
    if algo == "bitonic":
        v = vector_with_min_diff(N, 0, 255, 0.01, rng)
    else:
        v = vector_with_min_diff(N, 0, 1, 1.0 / N, rng)
    reset_device_peak(device)
    t0 = time.time()
    ct = ctx.encrypt(v, slots=slots)
    _sync(device)
    secs["encrypt"], mem["encrypt"] = time.time() - t0, _mem_gb(device)
    cfg_sign = p.sign_config()

    times, census, launches, encodes, bootstraps = [], [], [], [], []
    kernels = (cuda_ntt.ntt_fwd, cuda_ntt.ntt_inv)
    max_err = gate = prof_summary = None
    reset_device_peak(device)
    for t in range(trials):
        traced = profile_dir is not None and t == trials - 1
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) if traced \
            else contextlib.nullcontext()
        before = [kern.launches for kern in kernels]
        if hook is not None:
            hook.calls = []
        with prof:
            t0 = time.time()
            out = sort_fn(ct, cfg_sign)
            _sync(device)
            dt = time.time() - t0
        times.append(dt)
        if traced:
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                profile_dir, f"trace_{algo}_N{N}.json"))
            prof_summary = profile_summary(prof, dt)
        census.append(dict(ctx.op_counts))
        launches.append({kern.__name__: kern.launches - n0
                         for kern, n0 in zip(kernels, before)})
        encodes.append({"count": ctx.pt_encode_count,
                        "s": ctx.pt_encode_s})
        if hook is not None:
            bootstraps.append(hook.calls)
            log(f"[sort] trial {t}: {len(hook.calls)} bootstraps " +
                ", ".join(f"{c['s']:.2f}s {c['limbs_in']}->{c['limbs_out']}"
                          for c in hook.calls))
        log(f"[sort] trial {t}: {dt:.2f}s mults={ctx.mult_count} "
            f"rots={ctx.rot_count} precomps={ctx.precompute_count} "
            f"pt_encode={ctx.pt_encode_s:.1f}s/{ctx.pt_encode_count} "
            f"census={census[-1]}")
        ctx.op_counts.clear()
        ctx.pt_encode_s = 0.0
        ctx.pt_encode_count = 0
        if t == 0:
            first = out
            err = np.abs(ctx.decrypt(out)[:N] - np.sort(v))
            max_err = float(err.max())
            if algo == "bitonic":
                over = int((err > BITONIC_GATE[1]).sum())
                gate = {"max_err_below": BITONIC_GATE[0],
                        "slot_err_above": BITONIC_GATE[1],
                        "slots_above": over,
                        "ok": max_err < BITONIC_GATE[0] and over == 0}
            else:
                gate = {"max_err_below": GATE, "ok": max_err < GATE}
            log(f"[sort] max_err={max_err:.3e} "
                f"(log2={np.log2(max(max_err, 1e-300)):.2f}; gate {gate})")
    mem["sort"] = _mem_gb(device)
    best = min(times)
    base = BASELINE_HYBRID1.get(N) if algo == "hybrid1" else None
    rec = {"metric": f"encrypted_sort_{algo}_N{N}_ring2e{ring_log}",
           "value": round(best, 3), "unit": "s",
           "vs_baseline": round(best / base, 4) if base else None,
           "baseline_s": base, "max_err": max_err, "gate": gate,
           "trials": [round(x, 3) for x in times],
           "mults": ctx.mult_count, "rots": ctx.rot_count,
           "security_logqp": logqp, "security_ok": ok,
           "device_mem": mem, "resident_gb": resident_gb(ctx),
           "rot_keys": len(ctx.rot_keys),
           "key_budget_mb": cfg.rot_key_budget_mb,
           "key_regens": ctx.rot_keys.regen_count, "phase_s": secs,
           "op_census": census, "pt_encode": encodes,
           "ntt_launches": launches,
           **({"bootstraps": bootstraps} if boots else {}),
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else str(device))}
    if prof_summary is not None:
        rec["profile"] = prof_summary
    if os.environ.get("BENCH_MICRO", "0") == "1":
        # after the headline number, as the JAX harness runs it
        t0 = time.time()
        rec["micro"] = micro_bench(ctx)
        log(f"[micro] table {time.time() - t0:.1f}s")
    if keep is not None:
        keep.update(ctx=ctx, ct=ct, values=v, out=first, sign=cfg_sign,
                    params=p, slots=slots)
    return rec


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        log("no CUDA device: this benchmark measures the GPU port only")
        return 1
    algo = argv[0] if argv else "hybrid1"
    N = int(argv[1]) if len(argv) > 1 else 128
    ring_log = int(argv[2]) if len(argv) > 2 else 17
    trials = int(argv[3]) if len(argv) > 3 else 2
    k = int(argv[4]) if len(argv) > 4 else 2
    rec = None
    if os.environ.get("BENCH_SORT", "1") != "0":
        rec = sort_bench(algo, N, ring_log, trials,
                         profile_dir=os.environ.get("BENCH_PROFILE"), k=k)
    if os.environ.get("BENCH_NTT", "0") == "1" or rec is None:
        ntt = ntt_bench(ring_log)
        rec = ntt if rec is None else {**rec, "ntt": ntt}
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
