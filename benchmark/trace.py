"""Tracing of a `--trace 1` run, from the benchmark's own files.

`instrument(work, calls, annotate)` wraps, for the traced run only, the
port's NTT entry points (K1 `ntt_fwd`, K2 `ntt_inv`, as each module of
the port imported them) to log every call's logical shape, and, with
`annotate`, each public op of the evaluation context `work` in a
`ckks.<op>` profiler annotation, so that an idle gap of the device can
be named by the host op that covered it.
`summarize(prof, t0_ns, t1_ns)` reduces a torch.profiler run to what the
metric readers need: per card, the seconds in which an operation ran and
the seconds by device-op name, and the idle seconds by host op.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import inspect
import sys

import torch

PROGRAM = "sorting_fhe_tpu_torch"
NTT_KERNELS = ("col_pass", "chunk_pass")     # csrc/ntt.cu's two passes
ANNOTATION = "ckks."    # prefix of the ops' annotations
TOP = 10
NAME = 160          # characters of a name kept in the breakdown


def short(name: str) -> str:
    """A device op's or host op's name for the breakdown: C++ namespaces
    and `void` dropped, cut to NAME characters."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::",
                  "std::"):
        name = name.replace(noise, "")
    return name[:NAME]


def is_ntt(name: str) -> bool:
    return any(k in name for k in NTT_KERNELS)


@contextlib.contextmanager
def instrument(work, calls: list, annotate: bool):
    """Log each NTT call as (kind, numel, limbs, n) into `calls`, and
    with `annotate` wrap each public op of `work` in a profiler
    annotation, until the block exits."""
    from sorting_fhe_tpu_torch.core import cuda_ntt

    def logged(fn, kind):
        def call(x, tabs, rows):
            calls.append((kind, x.numel(), x.shape[-2], x.shape[-1]))
            return fn(x, tabs, rows)
        return call

    originals = {cuda_ntt.ntt_fwd: logged(cuda_ntt.ntt_fwd, "fwd"),
                 cuda_ntt.ntt_inv: logged(cuda_ntt.ntt_inv, "inv")}
    patched = []
    for name, mod in list(sys.modules.items()):
        if mod is cuda_ntt or not name.startswith(PROGRAM + "."):
            continue
        for attr, val in list(vars(mod).items()):
            if callable(val) and val in originals:
                setattr(mod, attr, originals[val])
                patched.append((mod, attr, val))

    def annotated(op, fn):
        def call(*a, **k):
            with torch.profiler.record_function(ANNOTATION + op):
                return fn(*a, **k)
        return call

    ops = [op for op in dir(type(work)) if annotate
           and not op.startswith("_")
           and inspect.isfunction(getattr(type(work), op))]
    for op in ops:
        setattr(work, op, annotated(op, getattr(work, op)))
    try:
        yield calls
    finally:
        for mod, attr, val in patched:
            setattr(mod, attr, val)
        for op in ops:
            delattr(work, op)


def mean_busy_s(summary: dict, chips: int) -> float:
    """Busy seconds of cards 0..chips-1 of a summary, their mean (a card
    on which nothing ran counts 0)."""
    cards = summary["cards"]
    return sum(cards[i]["busy_s"] for i in range(chips) if i in cards) \
        / chips


def _union(intervals: list) -> list:
    """Merged [start, end] intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class _HostNames:
    """The innermost host event covering a time: a `ckks.` annotation if
    one covers it, else any host op, else 'host: no op'."""

    def __init__(self, events: list):
        self.levels = []
        for pick in (lambda n: n.startswith(ANNOTATION), lambda n: True):
            ev = sorted((s, e, n) for s, e, n in events if pick(n))
            self.levels.append(([s for s, _, _ in ev], ev))

    def __call__(self, t: int) -> str:
        for starts, ev in self.levels:
            i = bisect.bisect_right(starts, t) - 1
            for j in range(i, max(i - 64, -1), -1):
                if ev[j][1] >= t:
                    return ev[j][2]
        return "host: no op"


def summarize(prof, t0_ns: int, t1_ns: int) -> dict:
    """Per card (by index): busy seconds (union of its kernels, copies
    and sets, clipped to [t0, t1]) and seconds by device-op name; device-op seconds
    summed over the cards (top 10); idle seconds inside [t0, t1] summed
    by the host op that covered each gap's midpoint (top 10)."""
    from torch.autograd import DeviceType
    dev = collections.defaultdict(list)
    host = []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        iv = (s, s + e.duration_ns(), e.name())
        if e.device_type() == DeviceType.CUDA:
            # the card's operations, not our annotations' spans on it
            if not e.name().startswith(ANNOTATION):
                dev[e.device_index()].append(iv)
        elif e.device_type() == DeviceType.CPU:
            host.append(iv)
    names = _HostNames(host)
    cards, ops = {}, collections.Counter()
    idle = collections.Counter()
    for d, ivs in sorted(dev.items()):
        by_name = collections.Counter()
        for s, e, n in ivs:
            by_name[n] += (e - s) / 1e9
        ops.update(by_name)
        merged = [[max(s, t0_ns), min(e, t1_ns)] for s, e in
                  _union([(s, e) for s, e, _ in ivs])
                  if e > t0_ns and s < t1_ns]
        busy = sum(e - s for s, e in merged) / 1e9
        edges = [t0_ns] + [x for iv in merged for x in iv] + [t1_ns]
        for a, b in zip(edges[::2], edges[1::2]):
            if b > a:
                idle[names((a + b) // 2)] += (b - a) / 1e9
        cards[d] = {"busy_s": busy, "ops": dict(by_name)}
    return {"window_s": (t1_ns - t0_ns) / 1e9, "cards": cards,
            "device_ops": [[short(n), s] for n, s in ops.most_common(TOP)],
            "idle_gaps": [[short(n), s] for n, s in idle.most_common(TOP)]}
