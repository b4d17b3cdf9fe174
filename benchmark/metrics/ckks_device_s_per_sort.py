"""Device seconds per sort of every operation outside the NTT kernels
(K1/K2's column and chunk passes): the CKKS ops' own work, the mean over
the cell's cards (profiler trace, the traced sorts)."""

from benchmark.trace import is_ntt


def read(run):
    if run.trace is None or not run.trace["cards"]:
        return None
    cards = run.trace["cards"]
    secs = sum(s for i in range(run.chips)
               for name, s in cards.get(i, {"ops": {}})["ops"].items()
               if not is_ntt(name)) / run.chips
    return secs / run.cell.traffic["traced_sorts"]
