"""The benchmark's layout: ``BENCHMARK.json`` within its contract, the
pieces found by name, a cell, configuration, traffic kind and metric added
as files alone, the result line's keys, and no import of JAX or the JAX
package."""

from __future__ import annotations

import ast
import json
import re
import shutil
from pathlib import Path

import pytest

from conftest import REPO

DOC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_top_level_keys():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert DOC["paths"] == ["benchmark"]
    assert DOC["command"] == ["python3", "benchmark/run.py"]
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fit_a_full_check():
    cells = 24
    total = (2 + 14 * cells) * (DOC["run_seconds"] + 60) + cells * 2 * 90
    assert 1 <= DOC["run_seconds"] <= 51 and total + 1200 <= 43200


def all_names():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in DOC[key]:
            yield key, entry["name"]


@pytest.mark.parametrize("key,name", list(all_names()))
def test_names_use_allowed_characters(key, name):
    assert NAME.match(name), name


def test_names_are_unique():
    for key in ("configs", "workloads"):
        names = [e["name"] for e in DOC[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in DOC["end_to_end"] + DOC["per_layer"]]
    assert len(metrics) == len(set(metrics))


@pytest.mark.parametrize("metric", DOC["end_to_end"] + DOC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entries(metric):
    end_to_end = metric in DOC["end_to_end"]
    keys = ({"name", "unit", "better", "bound", "source"} if end_to_end
            else {"name", "unit", "better", "source", "layer", "moves"})
    assert set(metric) - {"workloads"} == keys
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in (
        {"host_clock", "device_trace"} if end_to_end else SOURCES)
    cells = {c["name"] for c in DOC["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    from benchmark.core.spec import Spec

    assert Spec(REPO).reader_path(metric["name"]).is_file()
    if end_to_end:
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        moved = next(m for m in DOC["end_to_end"]
                     if m["name"] == metric["moves"])
        # every cell that reports the metric reports what it moves
        assert set(metric["workloads"]) <= set(
            moved.get("workloads", cells))
        assert "\n" not in metric["layer"] and len(metric["layer"]) <= 200


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for cell in DOC["workloads"]:
        def reports(m):
            return cell["name"] in m.get("workloads", [cell["name"]])
        e2e = [m["name"] for m in DOC["end_to_end"] if reports(m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(reports(m) for m in DOC["per_layer"])


@pytest.mark.parametrize("cell", DOC["workloads"], ids=lambda c: c["name"])
def test_cell_pieces_are_found_by_name(cell):
    from benchmark.core.spec import Spec

    spec = Spec(REPO)
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1 and len(cell["why"]) <= 200
    config, traffic = spec.config(cell), spec.traffic(cell)
    assert config["name"] == cell["config"]
    assert hasattr(spec.driver(traffic), "Driver")
    assert set(spec.limits(cell)) and all(
        isinstance(v, float) for v in spec.limits(cell).values())
    for m in spec.metrics(cell, False) + spec.metrics(cell, True):
        assert callable(spec.reader(m["name"]).read)


def test_configs_state_their_cut():
    for entry in DOC["configs"]:
        assert set(entry) == {"name", "source", "file", "reduced", "why"}
        assert entry["file"].startswith("benchmark/configs/")
        data = json.loads((REPO / entry["file"]).read_text())
        # the masked warp's threshold, off the published 1.0 (PERF.md §4)
        assert data["reduced"] == entry["reduced"] == ["mask_threshold"]
        assert data["mask_threshold"] < 1.0
        assert data["num_chs"] == [3, 16, 32, 64, 96, 128, 196]
        assert data["estimator_f_channels"] == [128, 128, 96, 64, 32]
        assert data["context_f_channels"] == [128, 128, 128, 96, 64, 32, 2]
        assert data["upflow"]["search_range"] == 4


def imports_of(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module


@pytest.mark.parametrize("path", sorted((REPO / "benchmark").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_and_a_plain_reference(path):
    tops = {name.split(".")[0] for name in imports_of(path)}
    assert not tops & {"jax", "jaxlib", "flax", "upflow_pytorch_tpu"}
    if "reference" in path.relative_to(REPO / "benchmark").parts:
        assert "upflow_pytorch_tpu_torch" not in tops
        assert not any(n.startswith("benchmark.") and not n.startswith(
            "benchmark.reference") for n in imports_of(path))


def test_result_line_keys(small_root, run_cell):
    rc, result, err = run_cell(small_root, "serve_bf16_kitti_b1")
    assert rc == 0
    assert list(result) == RESULT_KEYS + ["checks"]
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    # B=1 reports its rate per layer only (PERF.md §2)
    assert set(result["metrics"]) == {"setup_s", "serve_latency_p95_ms"}
    names = [line.split()[1] for line in err.strip().splitlines()[-2:]]
    assert names == list(result["checks"])
    rc, result, _ = run_cell(small_root, "serve_bf16_kitti_b1", trace=1)
    assert list(result) == RESULT_KEYS + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_cell_added_as_files_alone_runs(small_root, run_cell):
    """A configuration, a traffic mix of a new kind, a metric and a cell,
    each a new file or entry, run without an edit to any file there."""
    bench = small_root / "benchmark"
    conf = json.loads((bench / "configs" / "upflow_sgu_bf16_eval.json")
                      .read_text())
    conf.update(name="upflow_sgu_fp32_eval", precision="float32",
                control="tf32")
    conf["upflow"]["compute_dtype"] = "float32"
    (bench / "configs" / "upflow_sgu_fp32_eval.json").write_text(
        json.dumps(conf))
    shutil.copy(bench / "drivers" / "serve_closed_loop.py",
                bench / "drivers" / "serve_again.py")
    mix = json.loads((bench / "traffic" / "kitti_frame_b1_closed.json")
                     .read_text())
    mix["driver"] = "serve_again"
    (bench / "traffic" / "small_fp32.json").write_text(json.dumps(mix))
    (bench / "metrics" / "served_requests.py").write_text(
        "def read(run):\n    return float(run.window.calls)\n")
    (bench / "limits" / "serve_fp32_small.json").write_text(json.dumps(
        {"flow_epe_px": 1e-3, "occ_differ_share": 1e-3}))
    doc = json.loads((small_root / "BENCHMARK.json").read_text())
    doc["configs"].append(dict(doc["configs"][0], name="upflow_sgu_fp32_eval",
                               file="benchmark/configs/"
                                    "upflow_sgu_fp32_eval.json"))
    doc["workloads"].append(dict(name="serve_fp32_small",
                                 config="upflow_sgu_fp32_eval",
                                 traffic="small_fp32", chips=1, why="test"))
    doc["end_to_end"].append(dict(name="served_requests", unit="requests",
                                  better="higher", bound=0.05,
                                  source="host_clock",
                                  workloads=["serve_fp32_small"]))
    (small_root / "BENCHMARK.json").write_text(json.dumps(doc))
    rc, result, _ = run_cell(small_root, "serve_fp32_small")
    assert rc == 0 and result["correct"]
    assert result["metrics"]["served_requests"]["value"] == \
        result["attempted"]
    assert result["checks"]["flow_epe_px"]["value"] < 1e-4
