"""Nothing that benchmark/run.py loads imports JAX or the JAX package,
compared by whole top-level module names."""

import json
import subprocess
import sys
import types

from benchmark import cells, harness

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark import calibrate, cells, control, harness, reference
from benchmark import trace, traffic
import sorting_fhe_tpu_torch.bench
import sorting_fhe_tpu_torch.core.ckks
import sorting_fhe_tpu_torch.parallel.evaluator
import sorting_fhe_tpu_torch.parallel.mesh
import sorting_fhe_tpu_torch.registry
for w in cells.load_benchmark()["workloads"]:
    c = cells.load_cell(w["name"])
    for m in c.end_to_end + c.per_layer:
        cells.reader(c, m["name"])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_harness_and_port_load_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=str(cells.ROOT))],
        capture_output=True, text=True, check=True, timeout=300)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "sorting_fhe_tpu_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    for name in list(harness.forbidden_modules()):
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "sorting_fhe_tpu_torch",
                        types.ModuleType("sorting_fhe_tpu_torch"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "sorting_fhe_tpu.core",
                        types.ModuleType("y"))
    assert harness.forbidden_modules() == ["jax", "sorting_fhe_tpu"]
