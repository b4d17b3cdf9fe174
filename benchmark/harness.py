"""One run of one cell: set-up, a warm-up sort, the measured window of
back-to-back sorts, then the judge.

`main` is what `benchmark/run.py` runs on the card.  `Session` and
`run_cell` are the same steps with the device as an argument, so that
the tests drive them on the CPU at a small ring.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from . import cells, reference, trace, traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "sorting_fhe_tpu")
# the port reads these; a run of a cell takes its settings from the cell
CLEARED_ENV = ("SORTING_FHE_KEY_BUDGET_MB", "SORTING_FHE_PT_CACHE_MB",
               "SORTING_FHE_PT_HOST_CACHE_MB")


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (sorting_fhe_tpu_torch is not sorting_fhe_tpu)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def set_environment(root: Path):
    """Caches inside the checkout at fixed paths, no JAX behind a library,
    and none of the port's own knobs from outside."""
    cache = Path(root) / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    for k in CLEARED_ENV:
        os.environ.pop(k, None)


def counters(obj) -> dict:
    """A copy of obj's numeric attributes and dicts of numbers, the
    counters a metric reader takes differences of."""
    def numeric(v):
        if isinstance(v, dict):
            return all(numeric(x) for x in v.values())
        return isinstance(v, (int, float)) and not isinstance(v, bool)
    return {k: copy.deepcopy(v) for k, v in vars(obj).items()
            if numeric(v)} if obj is not None else {}


class Session:
    """The program as the cell's configuration states it, on `device`
    (with `mesh_devices` for a configuration of several mesh slots):
    context and keys from the port's registry, the sorter as
    bench.build_sorter makes it."""

    def __init__(self, cell: cells.Cell, seed: int, device="cuda:0",
                 mesh_devices=None):
        from sorting_fhe_tpu_torch.bench import build_sorter, mehp24_degrees
        from sorting_fhe_tpu_torch.core.ckks import CkksContext
        from sorting_fhe_tpu_torch.ops.sign import (CompositeSignConfig,
                                                    SignConfig)
        from sorting_fhe_tpu_torch.registry import full_config, get_params

        conf, ck = cell.config, cell.config["ckks"]
        traffic.check(cell.traffic)
        if ck["secret"] != "uniform_ternary":
            raise ValueError(f"unsupported secret {ck['secret']!r}")
        self.cell, self.seed = cell, seed
        self.algo, self.N = conf["sort"]["algo"], conf["sort"]["N"]
        p = get_params(self.algo, self.N)
        cfg = full_config(p, ring_dim=1 << ck["ring_log"],
                          scale_bits=ck["scale_bits"], dnum=ck["dnum"],
                          seed=seed,
                          rot_key_budget_mb=cell.traffic.get(
                              "rot_key_budget_mb"))
        self.ctx = CkksContext(cfg, device=device)
        P = self.ctx.params
        self.mismatches = (
            sum(a != b for a, b in zip(P.q, conf["chain"]["q"]))
            + sum(a != b for a, b in zip(P.p_special,
                                          conf["chain"]["special"]))
            + abs(P.nq - len(conf["chain"]["q"]))
            + abs(len(P.p_special) - len(conf["chain"]["special"]))
            + (p.mult_depth != ck["mult_depth"])
            + (self.algo == "mehp24"
               and list(mehp24_degrees(p)) != conf["sort"]["degrees"]))
        self.logqp = sum(int(q).bit_length() for q in P.all_primes)
        self.mesh = None
        self.work = self.ctx
        if conf.get("mesh_slots", 1) > 1:
            from sorting_fhe_tpu_torch.parallel.evaluator import shard_context
            from sorting_fhe_tpu_torch.parallel.mesh import make_mesh
            self.mesh = make_mesh(conf["mesh_slots"], devices=mesh_devices)
            self.work = shard_context(self.ctx, self.mesh)
        self.devices = (self.mesh.devices if self.mesh
                        else [self.ctx.device])
        self.sort_fn, self.slots, _ = build_sorter(
            self.work, self.algo, self.N, p,
            minimal_keys=conf["sort"]["minimal_keys"])
        self.sign = SignConfig(CompositeSignConfig(*conf["sort"]["sign"]),
                               mult_depth=ck["mult_depth"])
        self.work.sync()

    def encrypt(self, values: list) -> list:
        """The client's ciphertexts of `values`, placed as the sort takes
        them."""
        cts = [self.ctx.encrypt(v, slots=self.slots) for v in values]
        if self.mesh:
            cts = [self.work.shard(ct) for ct in cts]
        self.work.sync()
        return cts

    def sort(self, ct):
        """One sort, returned once every card of the cell has it."""
        out = self.sort_fn(ct, self.sign)
        self.work.sync()
        return out

    def snapshot(self) -> dict:
        return {"ctx": counters(self.ctx),
                "store": counters(self.ctx.rot_keys),
                "mesh": counters(self.mesh)}

    def output_data(self, out) -> tuple:
        """(uint32 [k, limbs, n] residues on the host, scale) of an
        output, gathered from the mesh's row blocks where it has them."""
        if self.mesh:
            out = out.gather(self.devices[0])
        return out.data.cpu().numpy().view(np.uint32), out.scale

    def reset_peaks(self):
        for d in self.devices:
            if d.type == "cuda":
                torch.cuda.reset_peak_memory_stats(d)

    def peak_bytes(self) -> int:
        return max((torch.cuda.max_memory_allocated(d)
                    for d in self.devices if d.type == "cuda"), default=0)


@dataclass
class Window:
    """What a window produced and what the readers read."""
    outputs: list                 # (input index, program output)
    seconds: float
    trace: dict | None = None
    ntt_calls: list = field(default_factory=list)


def run_window(s: Session, cts: list, seconds: float,
               traced_sorts: int = 0) -> Window:
    """Whole sorts back to back from the first sort's launch until
    `seconds` have passed (at least one sort), input i % len(cts) for
    sort i.  With `traced_sorts`, the first that many run under
    torch.profiler tracing the cards only, with the NTT calls logged
    (trace.instrument), for the device metrics; the next one under the
    profiler tracing the host too, with the ops annotated, to name the
    idle gaps.  Host tracing slows the host several-fold, so it stays out
    of the sorts that the device metrics read."""
    w = Window([], 0.0)
    cuda = any(d.type == "cuda" for d in s.devices)
    act = torch.profiler.ProfilerActivity
    phases = [] if not traced_sorts else [
        (traced_sorts, [act.CUDA] if cuda else [act.CPU], False),
        (1, [act.CPU, act.CUDA] if cuda else [act.CPU], True)]
    summaries = []
    t0 = time.perf_counter()
    for count, acts, annotate in phases:
        with trace.instrument(s.work, w.ntt_calls if not annotate else [],
                              annotate), \
                torch.profiler.profile(activities=acts) as prof:
            t_ns = time.time_ns()
            for _ in range(count):
                w.outputs.append(_next_sort(s, cts, len(w.outputs)))
            t1_ns = time.time_ns()
        summaries.append(trace.summarize(prof, t_ns, t1_ns))
    while not w.outputs or time.perf_counter() - t0 < seconds:
        w.outputs.append(_next_sort(s, cts, len(w.outputs)))
    w.seconds = time.perf_counter() - t0
    if summaries:
        w.trace = {**summaries[0], "idle_gaps": summaries[1]["idle_gaps"]}
    return w


def _next_sort(s: Session, cts: list, i: int) -> tuple:
    return i % len(cts), s.sort(cts[i % len(cts)])


@dataclass
class Run:
    """What the metric readers read (metrics/<name>.py: read(run))."""
    cell: cells.Cell
    chips: int
    device_kind: str
    setup_s: float
    window_s: float
    sorts: int
    peak_bytes: int
    before: dict                  # Session.snapshot() before the window
    after: dict                   # ... and after it
    errors: list                  # the judge's error of each sort
    trace: dict | None = None     # trace.summarize, with --trace 1
    ntt_calls: list = field(default_factory=list)


def judge(cell: cells.Cell, seed: int, outputs: list, values: list
          ) -> list:
    """The reference's largest error of each output (input index,
    residues, scale) against its sorted input; inf where it cannot read
    one."""
    conf = cell.config
    s = reference.secret_coeffs(1 << conf["ckks"]["ring_log"], seed)
    errors = []
    for idx, data, scale in outputs:
        try:
            errors.append(reference.sort_error(
                data, scale, conf["chain"]["q"], s, values[idx]))
        except (ValueError, IndexError, ZeroDivisionError) as e:
            log(f"[judge] output of input {idx} unreadable: {e!r}")
            errors.append(math.inf)
    return errors


def checks(cell: cells.Cell, mismatches: int, logqp: int, errors: list
           ) -> dict:
    """Each number compared, with its limit (a number passes at or
    under its limit): the largest error of any sort of the window, the
    program's departures from the configuration (its chain, depth and
    degrees) and the chain's log2(QP) against the security standard's
    ceiling."""
    conf = cell.config
    return {"max_err": {"value": max(errors, default=math.inf),
                        "limit": conf["check"]["max_err"]},
            "config_mismatches": {"value": int(mismatches), "limit": 0},
            "logqp": {"value": logqp,
                      "limit": conf["security"]["max_logqp"]}}


def run_cell(cell: cells.Cell, seed: int, seconds: float, traced: bool,
             device="cuda:0", mesh_devices=None, t_start=None,
             session: Session | None = None) -> dict:
    """One run: the result line's dict, its checks last.  `t_start` is the
    process's start on the host clock (perf_counter); `session`, a built
    Session of this cell and seed, is the tests' way to reuse one."""
    t_start = time.perf_counter() if t_start is None else t_start
    s = session or Session(cell, seed, device, mesh_devices)
    values = traffic.inputs(cell.config["data"], s.N, seed,
                            traffic.pool_size(cell.traffic, seconds))
    warm, *cts = s.encrypt(values)
    s.sort(warm)
    log(f"[setup] {s.ctx.params.describe()}; {len(cts)} inputs; warm-up "
        f"sort done at {time.perf_counter() - t_start:.2f}s")
    s.reset_peaks()
    before = s.snapshot()
    setup_s = time.perf_counter() - t_start
    w = run_window(s, cts, seconds,
                   cell.traffic["traced_sorts"] if traced else 0)
    peak = s.peak_bytes()
    after = s.snapshot()
    after["store"]["resident_bytes"] = s.ctx.rot_keys.resident_bytes
    after["ctx"]["relin_key_bytes"] = s.ctx.relin_key.nbytes
    # cts[i] holds values[1 + i]: values[0] went to the warm-up sort
    outputs = [(1 + idx, *s.output_data(out)) for idx, out in w.outputs]
    log(f"[window] {len(outputs)} sorts in {w.seconds:.3f}s")
    mismatches, logqp = s.mismatches, s.logqp
    kind = (torch.cuda.get_device_name(s.devices[0])
            if s.devices[0].type == "cuda" else "cpu")
    del w.outputs, warm, cts, s, session       # the program's state
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    errors = judge(cell, seed, outputs, values)
    done = checks(cell, mismatches, logqp, errors)
    run = Run(cell=cell, chips=cell.chips,
              device_kind=kind,
              setup_s=setup_s, window_s=w.seconds, sorts=len(errors),
              peak_bytes=peak, before=before, after=after, errors=errors,
              trace=w.trace, ntt_calls=w.ntt_calls)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = cells.reader(cell, m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    limit = done["max_err"]["limit"]
    ok = all(c["value"] <= c["limit"] for c in done.values())
    line = {"correct": ok, "attempted": len(errors),
            "failed": sum(not e <= limit for e in errors),
            "metrics": metrics,
            "device": {"platform": "gpu" if run.device_kind != "cpu"
                       else "cpu", "kind": run.device_kind,
                       "count": cell.chips, "memory_peak_bytes": peak}}
    if w.trace is not None:
        line["device"]["busy_s"] = trace.mean_busy_s(w.trace, cell.chips)
        line["device"]["window_s"] = w.trace["window_s"]
        line["breakdown"] = {k: w.trace[k] for k in ("device_ops",
                                                     "idle_gaps")}
    line["checks"] = done
    return line


def parse(argv: list) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number >= 0")
    return args


def main(argv: list, t_start: float) -> int:
    args = parse(argv)
    set_environment(cells.ROOT)
    cell = cells.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); torch "
            f"finds {torch.cuda.device_count()}: no result")
        return 2
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                    t_start=t_start)
    found = forbidden_modules()
    if found:
        log(f"loaded in this process after the window: {found}: no result")
        return 3
    for name, c in line["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0
