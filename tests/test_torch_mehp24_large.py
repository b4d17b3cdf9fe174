"""MEHP24's large-array sort (sort_large_array_fg: the input split into
blocks, sort_fg_multi's block-pair comparisons, the blocks combined)
through the benchmark's own path on the CPU.

tests/data/tiny-mehp24-n16-r8.json is the cell mehp24-n512-r17.seq cut
to ring 2^8: the registry's N=16 (depth 34, degrees (2, 2, 2, 2)) with
dnum 8.  Its 16 x 16 matrix does not fit the 128 slots, so
bench.build_sorter takes the large-array branch with two blocks of 8, as
N=512 takes two blocks of 256 at ring 2^17.  A sort takes about 12 s on
one CPU thread: the file runs four.  (N=32 at ring 2^10 took 74 s a sort
and runs out of levels at the registry's N=32 depth: the large-array
sort spends three levels more than sort_fg at the same degrees.)

Sound, the run is correct, its outputs decrypt (by the benchmark's plain
reference) to the PlainContext sort's, every stage's span is read and
the digit counter is the key switches' digits.  The control and two
faults of the large-array path are not correct.
"""

import contextlib
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import cells, control, harness, reference, traffic
from sorting_fhe_tpu_torch.models import mehp24 as M24
from sorting_fhe_tpu_torch.utils.plain import PlainContext

torch.set_num_threads(1)   # one thread per test worker: six share the cores

CONF = Path(__file__).resolve().parent / "data" / "tiny-mehp24-n16-r8.json"
SPANS = ("mehp24.split", "mehp24.compare", "mehp24.rank", "mehp24.place",
         "mehp24.combine")


@pytest.fixture(scope="module")
def tiny():
    """The cell mehp24-n512-r17.seq (its traffic and metrics) with the
    tiny configuration, and its Session on the CPU."""
    cell = dataclasses.replace(cells.load_cell("mehp24-n512-r17.seq"),
                               config=json.loads(CONF.read_text()))
    return cell, harness.Session(cell, 2**31 + 17, "cpu")


def test_sound_run(tiny, monkeypatch):
    cell, s = tiny
    conf, ctx = cell.config, s.ctx
    assert s.slots == 64 and M24.block_size(ctx.n // 2) == 8
    outs, digits = [], []
    sort_fn, keyswitch = s.sort_fn, ctx._keyswitch

    def recorded(ct, sign):
        outs.append(sort_fn(ct, sign))
        return outs[-1]

    def census(exts, tag, l):
        digits.append(exts.shape[0])
        return keyswitch(exts, tag, l)
    monkeypatch.setattr(s, "sort_fn", recorded)
    monkeypatch.setattr(ctx, "_keyswitch", census)
    before = harness.counters(ctx)
    line = harness.run_cell(cell, s.seed, 0, False, session=s)
    after = harness.counters(ctx)
    assert line["correct"] and line["attempted"] == 1 and not line["failed"]
    assert line["checks"]["config_mismatches"]["value"] == 0

    # the warm-up sort and the window's, decrypted by the plain reference,
    # against the port's sort on its PlainContext
    values = traffic.inputs(conf["data"], s.N, s.seed, len(outs))
    secret = reference.secret_coeffs(ctx.n, s.seed)
    for out, v in zip(outs, values):
        data, scale = s.output_data(out)
        got = reference.decode(reference.decrypt(data, conf["chain"]["q"],
                                                 secret), scale, s.N)
        pctx = PlainContext(ctx.n)
        want = M24.sort_large_array_fg(pctx, pctx.encrypt(v, slots=s.slots),
                                       s.N, 8, *conf["sort"]["degrees"])
        err = np.abs(got - pctx.decrypt(want)[:s.N]).max()
        assert err <= conf["check"]["max_err"], err

    assert all(ctx.span_s.get(name, 0) > 0 for name in SPANS), ctx.span_s
    switches = sum(after["op_counts"][k] - before["op_counts"].get(k, 0)
                   for k in ("mult_relin", "square_relin", "rotate_fused",
                             "fast_rotate"))
    assert len(digits) == switches > 0
    assert after["ks_digits"] - before["ks_digits"] == sum(digits)
    assert max(digits) == 8 == conf["ckks"]["dnum"]
    # the readers of the cell's per-layer metrics on those counters
    run = type("Run", (), {"before": {"ctx": before}, "after": {"ctx": after},
                           "sorts": len(outs)})
    assert cells.reader(cell, "ks_digits_per_sort")(run) == \
        sum(digits) / len(outs)
    for name, span in (("mehp24_compare_s_per_sort", "mehp24.compare"),
                       ("mehp24_place_s_per_sort", "mehp24.place")):
        assert cells.reader(cell, name)(run) == pytest.approx(
            (after["span_s"][span] - before["span_s"].get(span, 0))
            / len(outs))


def _control(monkeypatch, ctx):
    return control.lowered_indicator()


def _combine_without_block_1(monkeypatch, ctx):
    combine = M24.combine_ciphertext
    monkeypatch.setattr(M24, "combine_ciphertext",
                        lambda c, parts, sub_len: combine(c, parts[:1],
                                                          sub_len))
    return contextlib.nullcontext()


def _no_reuse(monkeypatch, ctx):
    """sort_fg_multi takes C_kj as 0 rather than 1 - C_jk."""
    rsub = ctx.rsub

    def fault(b, a):
        if sys._getframe(1).f_code is M24.sort_fg_multi.__code__:
            return ctx.zero_like(a)
        return rsub(b, a)
    monkeypatch.setattr(ctx, "rsub", fault)
    return contextlib.nullcontext()


@pytest.mark.parametrize("fault", [_control, _combine_without_block_1,
                                   _no_reuse])
def test_faults_are_not_correct(tiny, monkeypatch, fault):
    cell, s = tiny
    values = traffic.inputs(cell.config["data"], s.N, 3, 1)
    with fault(monkeypatch, s.ctx):
        outs = [(i, *s.output_data(s.sort(ct)))
                for i, ct in enumerate(s.encrypt(values))]
    done = harness.checks(cell, s.mismatches, s.logqp,
                          harness.judge(cell, s.seed, outs, values))
    assert done["max_err"]["value"] > 10 * done["max_err"]["limit"]
    assert not all(c["value"] <= c["limit"] for c in done.values())
