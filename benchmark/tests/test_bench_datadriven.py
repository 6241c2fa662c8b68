"""A later change adds a configuration, a traffic mix, a cell and a
per-layer metric as new files and entries: no file of the harness is
edited."""

import json
import shutil
import subprocess
import sys

from conftest import ROOT

PROBE = """
import json, sys
sys.path.insert(0, sys.argv[1])
from benchmark import harness
cell = harness.find_cell(harness.load_benchmark(), "infer.newcfg.b4")
print(json.dumps({"config": cell.config["name"],
                  "batch": cell.traffic["batch"],
                  "driver": cell.driver.__name__,
                  "metrics": [m["name"] for m in cell.per_layer],
                  "read": harness.metric_reader("probe.infer")({"units": 3})}))
"""


def test_new_entries_need_no_edit(tmp_path):
    root = tmp_path / "checkout"
    (root).mkdir()
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(root): p.read_bytes()
              for p in (root / "benchmark").rglob("*") if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    b = root / "benchmark"
    cfg = json.loads((b / "configs" / "adaptiveisp-fast-yolov3.json")
                     .read_text())
    cfg["name"] = "newcfg"
    (b / "configs" / "newcfg.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic" / "infer.b16.json").read_text())
    mix["batch"] = 4
    (b / "traffic" / "infer.b4.json").write_text(json.dumps(mix))
    (b / "metrics" / "probe.infer.py").write_text(
        "def read(layer):\n    return layer.get('units')\n")
    (b / "limits" / "infer.newcfg.b4.json").write_text(
        json.dumps({"limits": {"image_err": 1.0}}))
    bench["configs"].append({"name": "newcfg", "source": "x",
                             "file": "benchmark/configs/newcfg.json",
                             "reduced": [], "why": "probe"})
    bench["workloads"].append({"name": "infer.newcfg.b4", "config": "newcfg",
                               "traffic": "infer.b4", "chips": 1,
                               "why": "probe"})
    bench["per_layer"].append({"name": "probe.infer", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "rollout", "moves": "setup_s",
                               "workloads": ["infer.newcfg.b4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run([sys.executable, "-c", PROBE, str(root)],
                         capture_output=True, text=True, cwd=root,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"config": "newcfg", "batch": 4,
                   "driver": "benchmark.drivers.infer",
                   "metrics": ["probe.infer"], "read": 3}
    for rel, data in before.items():
        assert (root / rel).read_bytes() == data, rel
