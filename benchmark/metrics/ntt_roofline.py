"""The NTT kernels' share of their roofline, in percent: the least time
the card's memory needs for the bytes every K1/K2 call of the traced
sorts must move (roofline/ntt.py, from each call's logical shape), over
the device time of the kernels' passes (profiler trace).  Nothing to read
without a trace, without NTT kernels in it, or on a card the peaks table
lacks."""

from benchmark import roofline
from benchmark.roofline.ntt import call_bytes
from benchmark.trace import is_ntt


def read(run):
    peak = roofline.peaks(run.device_kind)
    if run.trace is None or peak is None:
        return None
    secs = sum(s for card in run.trace["cards"].values()
               for name, s in card["ops"].items() if is_ntt(name))
    if secs <= 0 or not run.ntt_calls:
        return None
    nbytes = sum(call_bytes(numel, limbs, n)
                 for _, numel, limbs, n in run.ntt_calls)
    return 100.0 * nbytes / peak["hbm_bytes_per_s"] / secs
