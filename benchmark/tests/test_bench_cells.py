"""Every cell of BENCHMARK.json loads from its files, and a cell added as
files alone is found without an edit to any file that is there."""

import hashlib
import json

from benchmark import cells

from .helpers import TINY, copy_with_tiny_cells

CELL_KEYS = {"name", "config", "traffic", "chips", "why"}


def test_every_cell_loads_from_its_files():
    bench = cells.load_benchmark()
    assert [w["name"] for w in bench["workloads"]]
    for w in bench["workloads"]:
        assert set(w) == CELL_KEYS
        c = cells.load_cell(w["name"])
        conf = next(x for x in bench["configs"] if x["name"] == w["config"])
        assert c.config["name"] == conf["name"]
        assert c.config["reduced"] == conf["reduced"]
        chain = c.config["chain"]
        assert chain["logqp"] == sum(p.bit_length() for p in
                                     chain["q"] + chain["special"])
        assert chain["logqp"] <= c.config["security"]["max_logqp"]
        assert {"min_sort_s", "traced_sorts"} <= set(c.traffic)
        e2e = {m["name"] for m in c.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
        for m in c.end_to_end + c.per_layer:
            assert callable(cells.reader(c, m["name"]))
            assert m.get("moves", "setup_s") in {x["name"] for x in
                                                 bench["end_to_end"]}


def test_cell_added_as_files_alone(tmp_path):
    before = {p: hashlib.sha256(p.read_bytes()).hexdigest()
              for p in cells.BENCH_DIR.rglob("*") if p.is_file()
              and "__pycache__" not in p.parts}
    root = copy_with_tiny_cells(tmp_path)
    metric = root / "benchmark" / "metrics" / "sorts_in_window.py"
    metric.write_text("def read(run):\n    return run.sorts\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "sorts_in_window", "unit": "sorts", "better": "higher",
        "source": "host_clock", "layer": "sort model", "moves": "sort_s",
        "workloads": ["tiny-hybrid1-n8-r10.seq"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for name, conf in TINY.items():
        c = cells.load_cell(name, root)
        assert c.config["name"] == conf and c.traffic["loop"] == "closed"
        assert c.bench_dir == root / "benchmark"
    c = cells.load_cell("tiny-hybrid1-n8-r10.seq", root)
    assert "sorts_in_window" in [m["name"] for m in c.per_layer]
    assert cells.reader(c, "sorts_in_window")(type("R", (), {"sorts": 3}))\
        == 3
    for p, digest in before.items():
        copy = root / "benchmark" / p.relative_to(cells.BENCH_DIR)
        assert hashlib.sha256(copy.read_bytes()).hexdigest() == digest
