"""Run one cell of BENCHMARK.json on this machine's cards:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Prints one JSON line last on stdout and the
numbers compared, each beside its limit, last on stderr.  Exits 2 without
the cards the cell needs and 3 if JAX or the JAX package got loaded."""

import time

T_START = time.perf_counter()

import sys                                             # noqa: E402
from pathlib import Path                               # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark.harness import main                     # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
