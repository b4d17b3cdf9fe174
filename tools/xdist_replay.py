"""Replay pytest-xdist's `--dist loadfile` schedule with measured test times.

    python -m pytest tests/ --collect-only -q -m 'not slow' > collected.txt
    python tools/xdist_replay.py run.xml collected.txt [-n 6] [--drop GLOB]

`run.xml` is the junit report of a whole run (per-test time: setup, call
and teardown); `collected.txt` lists the node ids in collection order.
The replay follows xdist's LoadScopeScheduling: files are queued by test
count, most first (ties in collection order); each worker takes one file,
then another while it has at most two tests pending, and one more
whenever a finished test leaves it at most two pending.  It prints when
each worker finishes and when and where each file starts.  `--drop`
removes the files matching a glob from the collection, to replay another
layout of the same suite with the same times.
"""

from __future__ import annotations

import argparse
import collections
import fnmatch
import heapq
import xml.etree.ElementTree as ET


def junit_times(path: str) -> dict[str, float]:
    """Node id -> seconds, from a junit report written by pytest."""
    times = {}
    for case in ET.parse(path).getroot().iter("testcase"):
        mod = case.get("classname", "").replace(".", "/")
        times[f"{mod}.py::{case.get('name')}"] = float(case.get("time", 0))
    return times


def replay(nodeids: list[str], times: dict[str, float], workers: int):
    """(finish time per worker, [(file, worker, start time)])."""
    units = collections.OrderedDict()
    for nid in nodeids:
        units.setdefault(nid.split("::", 1)[0], []).append(nid)
    queue = collections.deque(sorted(units.items(), key=lambda u: -len(u[1])))
    pending = [collections.deque() for _ in range(workers)]
    starts = []
    clock = [0.0] * workers

    def assign(w):
        name, tests = queue.popleft()
        starts.append((name, w, clock[w]))
        pending[w].extend(tests)

    for w in range(min(workers, len(queue))):
        assign(w)
    for w in range(workers):
        if queue and len(pending[w]) <= 2:
            assign(w)
    events = [(times.get(pending[w][0], 0.0), w)
              for w in range(workers) if pending[w]]
    heapq.heapify(events)
    while events:
        t, w = heapq.heappop(events)
        clock[w] = t
        pending[w].popleft()
        if queue and len(pending[w]) <= 2:
            assign(w)
        if pending[w]:
            heapq.heappush(events, (t + times.get(pending[w][0], 0.0), w))
    return clock, starts


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("junit")
    ap.add_argument("collected")
    ap.add_argument("-n", type=int, default=6)
    ap.add_argument("--drop", action="append", default=[])
    args = ap.parse_args()
    times = junit_times(args.junit)
    with open(args.collected) as f:
        nodeids = [ln.strip() for ln in f if "::" in ln]
    nodeids = [n for n in nodeids if not any(
        fnmatch.fnmatch(n.split("::", 1)[0], g) for g in args.drop)]
    missing = [n for n in nodeids if n not in times]
    clock, starts = replay(nodeids, times, args.n)
    for name, w, t in starts:
        print(f"start {t:8.1f}s worker {w}  {name}")
    for w, t in enumerate(clock):
        print(f"worker {w} finishes at {t:8.1f}s")
    print(f"makespan {max(clock):.1f}s over {len(nodeids)} tests "
          f"({len(missing)} without a time)")


if __name__ == "__main__":
    main()
