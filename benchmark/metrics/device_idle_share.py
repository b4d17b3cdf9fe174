"""Share of the traced window in which no operation ran on the card, the
mean over the cell's cards, in percent (profiler trace)."""

from benchmark.trace import mean_busy_s


def read(run):
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    busy = mean_busy_s(run.trace, run.chips)
    return 100.0 * (1.0 - busy / run.trace["window_s"])
