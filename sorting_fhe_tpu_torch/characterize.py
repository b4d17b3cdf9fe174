"""Sign-function characterizer: working precision / depth / runtime sweep.

Counterpart of sorting_fhe_tpu/characterize.py, a rebuild of the
reference's utils/sign_characterizer.cpp:60-245
(SignFunctionCharacterizer): encrypt inputs at +-10^-k, evaluate each sign
function, and shrink the step until the decrypted sign misses the
precisionThreshold; record the first failing decade as the working
precision, the levels the evaluation consumed, and the last execution
time.  Emits the reference's header format (GET_SIGN_FUNCTION_METRIC
X-macro lines, sign_characterizer.cpp:138-166) plus a JSON twin.

    python -m sorting_fhe_tpu_torch.characterize --generate-header [out.h]
    python -m sorting_fhe_tpu_torch.characterize --characterize CompositeSign_3_2
    python -m sorting_fhe_tpu_torch.characterize --characterize NaiveDiscrete --cpu

Runs on the unit-test tier (small ring) by default, on the card unless
--cpu (device="cpu") asks for the CPU; set CHARACTERIZE_RING /
CHARACTERIZE_DEPTH to sweep at other parameters.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import dataclass

import numpy as np

from .core.ckks import CkksContext
from .core.params import CkksConfig
from .ops.sign import (SignFunc, SignConfig, CompositeSignConfig, sign)


@dataclass
class PrecisionMetrics:
    """(sign_characterizer.cpp:51-55)"""
    depth: int
    working_precision: float
    execution_time_ms: float


def _build_context(device="cuda") -> CkksContext:
    ring_log = int(os.environ.get("CHARACTERIZE_RING", "10"))
    depth = int(os.environ.get("CHARACTERIZE_DEPTH", "30"))
    return CkksContext(CkksConfig(ring_dim=1 << ring_log, mult_depth=depth,
                                  scale_bits=52, comp=2, dnum=6),
                       device=device)


def characterize_function(ctx: CkksContext, func: SignFunc, cfg: SignConfig,
                          precision_threshold: float = 0.01,
                          max_decades: int = 8) -> PrecisionMetrics:
    """Shrink the probe magnitude by 10x per round until |sign(x) - ±1|
    exceeds the threshold (sign_characterizer.cpp:60-105).  The working
    precision is the last decade that still evaluated correctly
    (the reference reports step*10 at the failure point)."""
    metrics = PrecisionMetrics(0, 0.0, 0.0)
    step = 0.1
    nq = ctx.params.nq
    for _ in range(max_decades):
        ok = True
        for value in (-step, step):
            ct = ctx.encrypt(np.array([value]), slots=ctx.params.num_slots)
            t0 = time.time()
            out = sign(ctx, ct, func, cfg)
            got = float(np.asarray(ctx.decrypt(out))[0])
            metrics.execution_time_ms = (time.time() - t0) * 1000.0
            metrics.depth = (nq - out.limbs) // ctx.params.comp + \
                (out.noise_deg == 2)
            expected = 1.0 if value > 0 else -1.0
            if abs(got - expected) > precision_threshold:
                ok = False
                break
        if not ok:
            metrics.working_precision = step * 10
            return metrics
        step /= 10
    # sweep exhausted max_decades without a failure: report the reference's
    # never-failed sentinel (sign_characterizer.cpp: workingPrecision stays
    # 0.0) so a saturated sweep is distinguishable from a genuine failure
    metrics.working_precision = 0.0
    return metrics


# the reference's sweep list (sign_characterizer.cpp:107-119) extended with
# the n=3 family the sorting pipelines actually use
SWEEP = [
    ("NaiveDiscrete", SignFunc.NaiveDiscrete, SignConfig(
        CompositeSignConfig())),
    ("Tanh", SignFunc.Tanh, SignConfig(CompositeSignConfig())),
    ("CompositeSign3_2_2", SignFunc.CompositeSign, SignConfig(
        CompositeSignConfig(3, 2, 2))),
    ("CompositeSign3_3_2", SignFunc.CompositeSign, SignConfig(
        CompositeSignConfig(3, 3, 2))),
    ("CompositeSign_2_2", SignFunc.CompositeSign, SignConfig(
        CompositeSignConfig(4, 2, 2))),
    ("CompositeSign_3_3", SignFunc.CompositeSign, SignConfig(
        CompositeSignConfig(4, 3, 3))),
]


def generate_header(path: str = "sign_function_metrics.h",
                    device="cuda") -> dict:
    """Sweep everything; write the X-macro header + JSON twin
    (sign_characterizer.cpp:138-166)."""
    ctx = _build_context(device)
    results = {}
    lines = ["// Crypto Configuration:",
             "// Precision Threshold: 0.01",
             f"// Ring Dimension: {ctx.params.n}",
             f"// Multiplicative Depth: {ctx.cfg.mult_depth}",
             "",
             "#ifdef GET_SIGN_FUNCTION_METRIC"]
    for name, func, cfg in SWEEP:
        print(f"Characterizing {name}", file=sys.stderr, flush=True)
        m = characterize_function(ctx, func, cfg)
        results[name] = dict(depth=m.depth,
                             working_precision=m.working_precision,
                             execution_time_ms=round(m.execution_time_ms, 2))
        lines.append(f"GET_SIGN_FUNCTION_METRIC({name}, {m.depth}, "
                     f"{m.working_precision:.10g}, "
                     f"{m.execution_time_ms:.6g})")
    lines += ["#endif // GET_SIGN_FUNCTION_METRIC", ""]
    with open(path, "w") as f:
        f.write("\n".join(lines))
    with open(os.path.splitext(path)[0] + ".json", "w") as f:
        json.dump(results, f, indent=2)
    print(f"Generated header file: {path}")
    return results


def parse_func(name: str):
    """CompositeSign_<dg>_<df> / CompositeSign3_<dg>_<df> / NaiveDiscrete /
    Tanh / SignumPolycircuit (sign_characterizer.cpp:207-227)."""
    if name.startswith("CompositeSign"):
        head, dg, df = name.rsplit("_", 2)
        n = 3 if head.endswith("3") else 4
        return SignFunc.CompositeSign, SignConfig(
            CompositeSignConfig(n, int(dg), int(df)))
    table = {"NaiveDiscrete": SignFunc.NaiveDiscrete,
             "Tanh": SignFunc.Tanh,
             "SignumPolycircuit": SignFunc.SignumPolycircuit}
    if name not in table:
        raise ValueError(f"unknown function {name!r}; use "
                         "CompositeSign_<dg>_<df>, NaiveDiscrete, Tanh, "
                         "or SignumPolycircuit")
    return table[name], SignConfig(CompositeSignConfig())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--generate-header", nargs="?", const="sign_function_"
                   "metrics.h", metavar="PATH")
    g.add_argument("--characterize", metavar="FUNCTION")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    if args.generate_header:
        generate_header(args.generate_header, device)
        return
    func, cfg = parse_func(args.characterize)
    m = characterize_function(_build_context(device), func, cfg)
    print(f"Function: {args.characterize}")
    print(f"Depth: {m.depth}")
    print(f"Working Precision: {m.working_precision:.10g}")
    print(f"Execution Time: {m.execution_time_ms:.6g} ms")


if __name__ == "__main__":
    main()
