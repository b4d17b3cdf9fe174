"""A copy of the benchmark in a temporary directory with the test tier's
cells added as files and BENCHMARK.json entries only."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark import cells

DATA = Path(__file__).resolve().parent / "data"
TINY = {"tiny-hybrid1-n8-r10.seq": "tiny-hybrid1-n8-r10",
        "tiny-mehp24-n8-r10.seq": "tiny-mehp24-n8-r10",
        "tiny-hybrid1-n8-r10-mesh4.seq": "tiny-hybrid1-n8-r10-mesh4"}


def copy_with_tiny_cells(dst: Path) -> Path:
    """dst holding BENCHMARK.json and benchmark/ as the repository has
    them, plus the tiny cells: their configuration files copied into
    configs/ and their entries appended to BENCHMARK.json."""
    shutil.copytree(cells.BENCH_DIR, dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = cells.load_benchmark()
    for cell, conf in TINY.items():
        shutil.copy(DATA / f"{conf}.json", dst / "benchmark" / "configs")
        bench["configs"].append({
            "name": conf, "source": "test tier", "reduced": ["ring_log"],
            "file": f"benchmark/configs/{conf}.json", "why": "test tier"})
        bench["workloads"].append({"name": cell, "config": conf,
                                   "traffic": "seq", "chips": 1,
                                   "why": "test tier"})
        for m in bench["per_layer"]:
            m["workloads"].append(cell)
    (dst / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dst
