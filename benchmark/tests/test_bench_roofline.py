"""The NTT kernels' byte count, the yardstick of `ntt_roofline`."""

from benchmark import roofline
from benchmark.roofline.ntt import call_bytes


def test_main_class_bytes():
    # the main path's largest class, the top-level decompose of hybrid1
    # N=128: [4 digits, 119 rows, 2^17]; 623.9 MB, 0.1862 ms at 3.35 TB/s
    n = 1 << 17
    nbytes = call_bytes(4 * 119 * n, 119, n)
    assert nbytes == 623_902_720
    peak = roofline.peaks("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"]
    assert round(nbytes / peak * 1e3, 4) == 0.1862
    assert roofline.peaks("no such card") is None
