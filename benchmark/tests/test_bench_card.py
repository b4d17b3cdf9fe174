"""On the card: one short run of the first cell from the command line,
which prints a correct result last.  Skips without a CUDA device."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import cells


@pytest.mark.cuda
def test_first_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = cells.load_benchmark()["workloads"][0]["name"]
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell,
         "--seed", "12345", "--seconds", "1", "--trace", "0"],
        cwd=cells.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")


def test_no_card_means_no_result(monkeypatch, capsys):
    from benchmark import harness
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(harness, "set_environment", lambda root: None)
    cell = cells.load_benchmark()["workloads"][0]["name"]
    assert harness.main(["--workload", cell, "--seed", "1", "--seconds",
                         "1", "--trace", "0"], 0.0) == 2
    assert capsys.readouterr().out == ""
