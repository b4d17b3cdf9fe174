"""The sign characterizer of the torch port (characterize.py) against the
JAX package's.

Tier-1: `parse_func` and the header writer (with `characterize_function`
stubbed) match the JAX package's.

`slow`: `characterize_function` at `_build_context`'s ring 2^10, depth
30 gives the JAX package's depth and working precision for the
registry's sign ladder (3, 3, 2) and the CLI's fixed (4, 3, 3).

At most two tier-1 tests per file (see tests/test_torch_serial.py).
"""

import json

import pytest
import torch

from sorting_fhe_tpu import characterize as JChar
from sorting_fhe_tpu_torch import characterize as TChar

torch.set_num_threads(1)   # one thread per test worker: six share the cores


def test_parse_func_matches_jax():
    def parsed(C, name):
        try:
            f, cfg = C.parse_func(name)
        except ValueError:
            return "ValueError"
        c = cfg.compos
        return f.name, c.n, c.dg, c.df
    for name in ("CompositeSign_2_3", "CompositeSign3_3_2",
                 "CompositeSign_3_3", "NaiveDiscrete", "Tanh",
                 "SignumPolycircuit", "Bogus"):
        assert parsed(TChar, name) == parsed(JChar, name), name


def test_generate_header_matches_jax(tmp_path, monkeypatch):
    """The header and its JSON twin, with characterize_function stubbed
    (one fixed result per SWEEP entry) and a stand-in context."""
    class _Ctx:
        class params:
            n = 1 << 10

        class cfg:
            mult_depth = 30

    texts = []
    for C in (JChar, TChar):
        metrics = iter(C.PrecisionMetrics(12 + i, 10.0 ** -i, 1.5 * i + 0.25)
                       for i in range(len(C.SWEEP)))
        monkeypatch.setattr(C, "_build_context", lambda *a: _Ctx())
        monkeypatch.setattr(C, "characterize_function",
                            lambda ctx, func, cfg: next(metrics))
        path = tmp_path / C.__name__ / "sign_function_metrics.h"
        path.parent.mkdir()
        C.generate_header(str(path))
        texts.append((path.read_text(), json.loads(
            path.with_suffix(".json").read_text())))
    assert texts[1] == texts[0]
    assert "GET_SIGN_FUNCTION_METRIC(CompositeSign3_2_2, 14, 0.01, 3.25)" \
        in texts[1][0]


@pytest.mark.slow
@pytest.mark.parametrize("name", ["CompositeSign3_3_2", "CompositeSign_3_3"])
def test_characterize_matches_jax(name):
    """The registry's sign ladder (3, 3, 2) and the CLI's fixed (4, 3, 3),
    which spends 12 levels more (27 against 15): the CLI's fault against
    the registry's depths, which are sized for the ladder."""
    res = []
    for C in (JChar, TChar):
        func, cfg = C.parse_func(name)
        ctx = C._build_context("cpu") if C is TChar else C._build_context()
        res.append(C.characterize_function(ctx, func, cfg, max_decades=2))
    (jm, tm) = res
    assert (tm.depth, tm.working_precision) == (jm.depth, jm.working_precision)
    assert tm.depth == {"CompositeSign3_3_2": 15,
                        "CompositeSign_3_3": 27}[name]
