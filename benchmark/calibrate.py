"""Readings that the `correct` limit of a cell is set from (not run by
the benchmark's own runs):

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 --sorts 2

One process builds the cell's program once (keys from the first seed),
then for each seed sorts `sorts` inputs drawn from it and prints the
judge's largest error; then the same with the control switched on
(control.lowered_indicator).  One JSON line per seed on stdout."""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import cells, control, harness, traffic  # noqa: E402


def readings(s, cell, seeds, sorts, key_seed):
    for seed in seeds:
        values = traffic.inputs(cell.config["data"], s.N, seed, sorts)
        t0 = time.perf_counter()
        outs = [(i, *s.output_data(s.sort(ct)))
                for i, ct in enumerate(s.encrypt(values))]
        secs = time.perf_counter() - t0
        errs = harness.judge(cell, key_seed, outs, values)
        yield {"seed": seed, "max_err": max(errs), "errors": errs,
               "sort_s": secs / sorts}


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--sorts", type=int, default=1)
    args = ap.parse_args(argv)
    harness.set_environment(cells.ROOT)
    cell = cells.load_cell(args.workload)
    seeds = [int(x) for x in args.seeds.split(",")]
    ctl = [int(x) for x in args.control_seeds.split(",") if x]
    s = harness.Session(cell, seeds[0], "cuda:0")
    s.sort(s.encrypt(traffic.inputs(cell.config["data"], s.N, seeds[0],
                                    1))[0])
    for r in readings(s, cell, seeds, args.sorts, seeds[0]):
        print(json.dumps({"workload": cell.name, "run": "program", **r}),
              flush=True)
    with control.lowered_indicator():
        for r in readings(s, cell, ctl, args.sorts, seeds[0]):
            print(json.dumps({"workload": cell.name, "run": "control", **r}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
