"""Homomorphic sign approximations.

Rebuild of reference/src/sign.{h,cpp}: four evaluators
selected by SignFunc, with the composite f/g iteration of Cheon et al.,
"Efficient Homomorphic Comparison Methods with Optimal Complexity"
(eprint 2019/1234).  Polynomial constants follow that public paper /
the reference's choices (sign.cpp:9-157); evaluation structure is ours
(functional JAX ops instead of OpenMP sections — the parallel sections
run as batched tensor ops, see SURVEY.md §2.3).

Lazy bootstrap hooks mirror sign.cpp:160-185; pass a
core.bootstrap.BootstrapHook (the real EvalBootstrap) or provision depth.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Callable, Optional

from ..core.ckks import CkksContext, Ciphertext
from ..core.poly_eval import eval_chebyshev_series_ps, eval_chebyshev_function


class SignFunc(enum.Enum):
    CompositeSign = 0
    SignumPolycircuit = 1
    Tanh = 2
    NaiveDiscrete = 3


@dataclass
class CompositeSignConfig:
    n: int = 3       # which f/g family (3 or 4)
    dg: int = 2      # g iterations
    df: int = 2      # f iterations


@dataclass
class SignConfig:
    compos: CompositeSignConfig
    mult_depth: int = 0   # total depth budget, for lazy bootstrap decisions
    # lazy-bootstrap hook (reference sign.cpp:160-185: bootstraps between
    # f/g iterations when remaining depth < required + 2)
    bootstrap_hook: Optional[Callable] = None


# depth consumed by one application of g_n / f_n
G_DEPTH = {3: 3, 4: 4}
F_DEPTH = {3: 3, 4: 4}


def _odd_poly7(ctx: CkksContext, x: Ciphertext, c1, c3, c5, c7) -> Ciphertext:
    """c1 x + c3 x^3 + c5 x^5 + c7 x^7 in depth 3 (reference sign.cpp:15-59
    evaluation shape)."""
    x2 = ctx.square(x)
    x4 = ctx.square(x2)
    y = ctx.mult_scalar(x, c1)
    y = ctx.add(y, ctx.mult(ctx.mult_scalar(x, c3), x2))
    c5x = ctx.mult_scalar(x, c5)
    c7x3 = ctx.mult(ctx.mult_scalar(x, c7), x2)
    y = ctx.add(y, ctx.mult(ctx.add(c5x, c7x3), x4))
    return y


def _g3(ctx, x):
    # g_3(x) = (4589x - 16577x^3 + 25614x^5 - 12860x^7)/2^10
    return _odd_poly7(ctx, x, 4589.0 / 1024.0, -16577.0 / 1024.0,
                      25614.0 / 1024.0, -12860.0 / 1024.0)


def _f3(ctx, x):
    # f_3(x) = (35x - 35x^3 + 21x^5 - 5x^7)/2^4
    return _odd_poly7(ctx, x, 35.0 / 16.0, -35.0 / 16.0,
                      21.0 / 16.0, -5.0 / 16.0)


# g_4 as a degree-27 Chebyshev series (reference sign.cpp:66-77)
_G4_CHEB = [
    0.0, 1.077117252745569, 0.0, -0.36166113998402755,
    0.0, 0.2137420717859748, 0.0, -0.15635204788780485,
    0.0, 0.11749645501187332, 0.0, -0.10074154666447852,
    0.0, 0.08002086947825496, 0.0, -0.07533558758484624,
    0.0, 0.059514472116534836, 0.0, -0.06146663712787884,
    0.0, 0.04570084927999001, 0.0, -0.05403683682999072,
    0.0, 0.03364293851188723, 0.0, -0.054459493266273494,
]

# f_4 degree-15 odd polynomial (reference sign.cpp:81-88)
_F4 = dict(c1=3.14208984375, c3=-7.33154296875, c5=13.19677734375,
           c7=-15.71044921875, c9=12.21923828125, c11=-5.99853515625,
           c13=1.69189453125, c15=-0.20947265625)


def _g4(ctx, x):
    return eval_chebyshev_series_ps(ctx, x, _G4_CHEB, -1.0, 1.0)


def _f4(ctx, x):
    """Degree-15 odd poly in depth 4 (x, x^2, x^4, x^8 ladder; the
    reference's OpenMP section structure collapses to batched tensor ops)."""
    c = _F4
    x2 = ctx.square(x)
    x4 = ctx.square(x2)
    x8 = ctx.square(x4)
    y = ctx.mult_scalar(x, c["c1"])
    y = ctx.add(y, ctx.mult(ctx.mult_scalar(x, c["c3"]), x2))
    t = ctx.add(ctx.mult_scalar(x, c["c5"]),
                ctx.mult(ctx.mult_scalar(x, c["c7"]), x2))
    y = ctx.add(y, ctx.mult(t, x4))
    t1 = ctx.add(ctx.mult_scalar(x, c["c9"]),
                 ctx.mult(ctx.mult_scalar(x, c["c11"]), x2))
    t2 = ctx.add(ctx.mult_scalar(x, c["c13"]),
                 ctx.mult(ctx.mult_scalar(x, c["c15"]), x2))
    t1 = ctx.add(t1, ctx.mult(t2, x4))
    y = ctx.add(y, ctx.mult(t1, x8))
    return y


def _remaining_levels(ctx: CkksContext, ct: Ciphertext) -> int:
    P = ctx.params
    return (ct.limbs - P.base_limbs) // P.comp


def composite_sign(ctx: CkksContext, x: Ciphertext, cfg: SignConfig,
                   n: int) -> Ciphertext:
    """dg iterations of g_n then df of f_n, with the reference's lazy
    bootstrap between iterations when remaining depth < required + 2
    (sign.cpp:160-185)."""
    g = _g3 if n == 3 else _g4
    f = _f3 if n == 3 else _f4

    def ensure(y, need):
        if cfg.bootstrap_hook is not None and \
                _remaining_levels(ctx, y) < need + 2:
            y = cfg.bootstrap_hook(y)
        return y

    y = ensure(x, G_DEPTH[n])
    y = g(ctx, y)
    for _ in range(1, cfg.compos.dg):
        y = ensure(y, G_DEPTH[n])
        y = g(ctx, y)
    for _ in range(cfg.compos.df):
        y = ensure(y, F_DEPTH[n])
        y = f(ctx, y)
    return y


def signum_polycircuit_coefficients(exact: bool = True):
    """Degree-1023 Chebyshev coefficient table of sign(x) on [-1, 1].

    exact=True (default) loads the reference's verbatim constants
    (sign.cpp:191-445 main series + the hand-unrolled tail terms
    T1009..T1023, sign.cpp:469-571, assembled into one vector) — numeric
    spec data, kept for bit-level test-vector parity.  exact=False
    regenerates them from the same Chebyshev interpolation of sign
    (agrees to ~1e-5; the reference's values come from an external
    fitting tool with a slightly different node count)."""
    import os
    import numpy as np
    if exact:
        path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                            "data", "signum_polycircuit_coeffs.npy")
        if os.path.exists(path):
            return np.load(path)
    from ..core.poly_eval import chebyshev_coefficients
    coeffs = chebyshev_coefficients(np.sign, -1.0, 1.0, 1023)
    coeffs[0::2] = 0.0          # sign is odd: exact zeros, kills noise
    return coeffs


def signum_polycircuit(ctx: CkksContext, x: Ciphertext,
                       exact: bool = True) -> Ciphertext:
    """Degree-1023 Chebyshev series of sign(x) on [-1, 1]
    (reference sign.cpp:189-608, the FHERMA polycircuit entry).

    The reference hand-unrolls the tail terms T1009..T1023 around
    OpenFHE's series-degree limit; our Paterson-Stockmeyer evaluator
    takes the full degree directly with the same coefficients."""
    return eval_chebyshev_series_ps(
        ctx, x, signum_polycircuit_coefficients(exact))


def naive_discrete_sign(ctx: CkksContext, x: Ciphertext) -> Ciphertext:
    """Degree-119 Chebyshev step function (reference sign.cpp:610-624)."""
    return eval_chebyshev_function(
        ctx, lambda t: 1.0 if t >= 0 else 0.0, x, -1.0, 1.0, 119)


def tanh_sign(ctx: CkksContext, x: Ciphertext) -> Ciphertext:
    """Degree-1006 Chebyshev of tanh(RAND_MAX * x) (sign.cpp:626-633)."""
    import numpy as np
    rm = float(2 ** 31 - 1)
    return eval_chebyshev_function(
        ctx, lambda t: float(np.tanh(t * rm)), x, -1.0, 1.0, 1006)


def sign(ctx: CkksContext, x: Ciphertext, func: SignFunc,
         cfg: SignConfig) -> Ciphertext:
    """Dispatcher (reference sign.cpp:635-651)."""
    if func == SignFunc.CompositeSign:
        return composite_sign(ctx, x, cfg, cfg.compos.n)
    if func == SignFunc.NaiveDiscrete:
        return naive_discrete_sign(ctx, x)
    if func == SignFunc.Tanh:
        return tanh_sign(ctx, x)
    if func == SignFunc.SignumPolycircuit:
        return signum_polycircuit(ctx, x)
    raise ValueError(func)
