"""The harness finds each cell's, configuration's and metric's files by
name, a new one is added by files alone, and a run's last line has the
contract's keys."""

import importlib
import json
import os
import os.path as osp
import shutil
import subprocess
import sys

import pytest

ROOT = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

SPEC = harness.load_json(osp.join(ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_file_a_cell_names_is_found(name):
    cell = harness.Cell(name)
    assert cell.traffic["entry"] in ("train", "eval")
    importlib.import_module(f"benchmark.entries.{cell.traffic['entry']}")
    assert callable(cell.counts().iteration_flops)
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.reader(m["name"]).read)
    assert set(cell.limits) and all(v > 0 for v in cell.limits.values())
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer one
    names = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer


NEW = """
import json, sys
sys.path[0] = {root!r}
from benchmark import harness
cell = harness.Cell("new.cell")
run = harness.Run(cell, None)
run.iter_ms = [1.0, 2.0, 3.0]
print(json.dumps({{"per_layer": [m["name"] for m in cell.per_layer],
                  "read": harness.read_metrics(run, cell.per_layer),
                  "flops": cell.counts().iteration_flops(cell.params,
                                                         "train"),
                  "limits": cell.limits}}))
"""


def test_a_cell_config_and_metric_are_added_by_files_only(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(osp.join(ROOT, "benchmark"), copy / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    before = {f: open(osp.join(ROOT, "benchmark", f)).read()
              for f in os.listdir(osp.join(ROOT, "benchmark"))
              if f.endswith(".py")}
    b = copy / "benchmark"
    cfg = json.loads((b / "configs" / "pointnet2_msg.json").read_text())
    cfg["name"] = "new_cfg"
    (b / "configs" / "new_cfg.json").write_text(json.dumps(cfg))
    shutil.copy(b / "counts" / "pointnet2_msg.py", b / "counts" / "new_cfg.py")
    traffic = json.loads((b / "traffic" / "semisup_convex.json").read_text())
    traffic["params"]["batch_size"] = 8
    (b / "traffic" / "new_traffic.json").write_text(json.dumps(traffic))
    (b / "workloads" / "new.cell.json").write_text(json.dumps(
        {"limits": {"loss_gap": 1.0}}))
    (b / "metrics" / "new_metric.py").write_text(
        "def read(run):\n    return max(run.iter_ms)\n")
    (b / "metrics" / "new_metric.own.py").write_text(
        "def read(run):\n    return min(run.iter_ms)\n")
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "new_cfg", "source": "x",
                            "file": "benchmark/configs/new_cfg.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "new.cell", "config": "new_cfg",
                              "traffic": "new_traffic", "chips": 1,
                              "why": "x"})
    for name in ("new_metric", "new_metric.twin", "new_metric.own"):
        spec["per_layer"].append({"name": name, "unit": "ms",
                                  "better": "lower",
                                  "source": "device_trace", "layer": "x",
                                  "moves": "train_clouds_per_s",
                                  "workloads": ["new.cell"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(spec))
    out = subprocess.run([sys.executable, "-c", NEW.format(root=str(copy))],
                         capture_output=True, text=True, timeout=120,
                         cwd=copy)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert "new_metric" in got["per_layer"]
    assert got["read"]["new_metric"]["value"] == 3.0
    # a split quantity without a file of its own is read by the
    # quantity's reader; one with a file, by its own
    assert got["read"]["new_metric.twin"]["value"] == 3.0
    assert got["read"]["new_metric.own"]["value"] == 1.0
    assert got["flops"] > 0 and got["limits"] == {"loss_gap": 1.0}
    for f, text in before.items():
        assert (b / f).read_text() == text


DRY = """
import json, sys
sys.path[0] = {root!r}
from benchmark import harness
from benchmark.tests.tiny import dry_run
result, _ = dry_run({workload!r}, trace={trace!r})
print(json.dumps({{"result": result,
                  "forbidden": harness.forbidden_modules()}}))
"""


@pytest.fixture(scope="module")
def dry(request):
    """A tiny CPU run of the MSG training cell, untraced and traced, each
    in a process of its own."""
    out = {}
    for trace in (False, True):
        p = subprocess.run(
            [sys.executable, "-c", DRY.format(root=ROOT,
                                              workload="msg.semisup_convex",
                                              trace=trace)],
            capture_output=True, text=True, timeout=600, cwd=ROOT)
        assert p.returncode == 0, p.stderr[-4000:]
        out[trace] = json.loads(p.stdout.strip().splitlines()[-1])
    return out


def test_the_result_line_has_the_contract_keys(dry):
    plain, traced = dry[False]["result"], dry[True]["result"]
    assert list(plain) == ["correct", "attempted", "failed", "metrics",
                           "device", "checks"]
    assert list(traced) == ["correct", "attempted", "failed", "metrics",
                            "device", "breakdown", "checks"]
    cell = harness.Cell("msg.semisup_convex")
    assert set(plain["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert set(traced["metrics"]) <= {m["name"] for m in cell.per_layer}
    for r in (plain, traced):
        assert r["correct"] is True and r["failed"] == 0
        assert set(r["device"]) >= {"platform", "kind", "count",
                                    "memory_peak_bytes"}
        assert set(r["checks"]) == set(cell.limits)
    assert {"busy_s", "window_s"} <= set(traced["device"])


def test_a_run_loads_no_jax(dry):
    assert dry[False]["forbidden"] == [] and dry[True]["forbidden"] == []


def test_the_command_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "msg.semisup_convex", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
