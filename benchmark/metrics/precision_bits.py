"""-log2 of the largest absolute error, over every sort of the window,
of the reference's decryption against the sorted input."""

import math


def read(run):
    worst = max(run.errors, default=math.inf)
    return -math.log2(worst) if 0 < worst < math.inf else None
