"""A run of the test tier's cells on the CPU, driven through
harness.run_cell past the look for a card: sound, it is correct; with
the control switched on, or with the timed path broken underneath, it is
not.  The cells are in a temporary copy, added as files alone."""

import numpy as np
import pytest
import torch

from benchmark import cells, control, harness

from .helpers import copy_with_tiny_cells

SECONDS = 0             # a window of one sort


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return copy_with_tiny_cells(tmp_path_factory.mktemp("bench"))


@pytest.fixture(scope="module")
def h1(root):
    cell = cells.load_cell("tiny-hybrid1-n8-r10.seq", root)
    return cell, harness.Session(cell, 2**31 + 11, "cpu")


def run(cell, s, traced=False):
    return harness.run_cell(cell, s.seed, SECONDS, traced, session=s)


def test_sound_run_is_correct(h1):
    cell, s = h1
    line = run(cell, s)
    assert line["correct"] and line["attempted"] >= 1 and not line["failed"]
    assert {"sort_s", "precision_bits", "setup_s"} <= set(line["metrics"])
    assert list(line)[-1] == "checks"
    assert line["checks"]["max_err"]["value"] < 1e-6
    traced = run(cell, s, traced=True)
    assert traced["correct"]
    m = traced["metrics"]
    assert m["keyswitch_per_sort"]["value"] > 0
    assert m["key_regens_per_sort"]["value"] == 0
    assert "ntt_roofline" not in m          # no card, nothing to read


@pytest.mark.parametrize("cell_name", ["tiny-hybrid1-n8-r10.seq",
                                       "tiny-mehp24-n8-r10.seq"])
def test_control_is_not_correct(root, h1, cell_name):
    cell = cells.load_cell(cell_name, root)
    s = h1[1] if cell_name == h1[0].name else \
        harness.Session(cell, 77, "cpu")
    with control.lowered_indicator():
        line = run(cell, s)
    assert not line["correct"] and line["failed"] == line["attempted"]
    assert line["checks"]["max_err"]["value"] > 1e-2


def _unchanged(s, ct):
    return ct


def _half_left_out(s, ct):
    out = s.sort_fn(ct, s.sign)
    mask = np.repeat([1.0, 0.0], s.N // 2)
    return s.work.mult_plain(out, mask, slots=out.slots)


def _answer_altered(s, ct):
    out = s.sort_fn(ct, s.sign)
    bump = np.zeros(out.slots)
    bump[0] = 1e-3
    return s.work.add(out, s.work.make_plaintext(bump, out.limbs, out.scale,
                                                 out.slots))


@pytest.mark.parametrize("fault", [_unchanged, _half_left_out,
                                   _answer_altered])
def test_broken_timed_path_is_not_correct(h1, monkeypatch, fault):
    cell, s = h1
    monkeypatch.setattr(s, "sort", lambda ct: fault(s, ct))
    line = run(cell, s)
    assert not line["correct"] and line["failed"] == line["attempted"]


def test_mesh_exchange_left_out_is_not_correct(root, monkeypatch):
    from sorting_fhe_tpu_torch.parallel import collective, evaluator
    cell = cells.load_cell("tiny-hybrid1-n8-r10-mesh4.seq", root)
    s = harness.Session(cell, 5, "cpu",
                        mesh_devices=[torch.device("cpu")] * 4)
    assert run(cell, s)["correct"]

    def local_only(blocks, mesh, axis, tag):
        return [torch.cat([b if j == i else torch.zeros_like(b)
                           for j, b in enumerate(blocks)], dim=axis)
                for i in range(len(blocks))]
    for mod in (collective, evaluator):
        monkeypatch.setattr(mod, "all_gather", local_only)
    line = run(cell, s)
    assert not line["correct"] and line["failed"] == line["attempted"]
