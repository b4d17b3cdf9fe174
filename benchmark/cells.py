"""The cells of BENCHMARK.json, resolved to their files by name.

A cell (an entry of `workloads`) names a configuration, whose file the
`configs` entry gives, and a traffic mix, `<bench_dir>/traffic/<name>.json`.
Every metric is read by `<bench_dir>/metrics/<name>.py`, whose `read(run)`
returns the number or None.  Adding a cell, a mix or a metric adds files
and BENCHMARK.json entries and edits nothing else.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)   # BENCHMARK.json entries
    per_layer: list = field(default_factory=list)
    bench_dir: Path = BENCH_DIR


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its configuration,
    traffic and metrics (those whose `workloads` name it; a per-layer
    metric without the key goes with every cell that reports the
    end-to-end metric it moves)."""
    root = Path(root)
    bench = load_benchmark(root)
    w = _by_name(bench["workloads"], name, "workload")
    conf = _by_name(bench["configs"], w["config"], "configuration")
    bench_dir = root / bench["paths"][0]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", ())
             or ("workloads" not in m and m["moves"] in moved)]
    return Cell(name=name, chips=w["chips"],
                config=json.loads((root / conf["file"]).read_text()),
                traffic=json.loads(
                    (bench_dir / "traffic" / f"{w['traffic']}.json")
                    .read_text()),
                end_to_end=e2e, per_layer=layer, bench_dir=bench_dir)


def reader(cell: Cell, metric: str):
    """`read` of <bench_dir>/metrics/<metric>.py."""
    path = cell.bench_dir / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
