"""Finds a cell's pieces by name.  ``BENCHMARK.json`` names the cell's
configuration (its file) and traffic mix; the mix is
``benchmark/traffic/<traffic>.json``, whose ``driver`` names
``benchmark/drivers/<driver>.py``; each metric is read by
``benchmark/metrics/<metric>.py`` or, where that file is absent, by the
reader of the name up to its last dot (``mfu.py`` reads ``mfu.serve`` and
``mfu.train``); each op's bytes and operations are
``benchmark/ops/<op>.py``, and each cell's limits on the numbers that
decide ``correct`` are ``benchmark/limits/<cell>.json``."""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

ROOT = Path(__file__).resolve().parents[2]


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """A module from a file of the benchmark, under a name made from its
    path (a metric's file name may hold dots)."""
    name = "bench_%s_%s" % (path.parent.name, path.stem.replace(".", "_"))
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


class Spec:
    """``BENCHMARK.json`` and the files it leads to, under ``root``."""

    def __init__(self, root: Path = ROOT):
        self.root = root
        self.bench = root / "benchmark"
        self.doc = load_json(root / "BENCHMARK.json")

    def cell(self, name: str) -> Dict[str, Any]:
        for cell in self.doc["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError("no workload %r; the cells are %s" % (
            name, [c["name"] for c in self.doc["workloads"]]))

    def config(self, cell: Dict[str, Any]) -> Dict[str, Any]:
        for conf in self.doc["configs"]:
            if conf["name"] == cell["config"]:
                return load_json(self.root / conf["file"])
        raise KeyError("no config %r" % cell["config"])

    def traffic(self, cell: Dict[str, Any]) -> Dict[str, Any]:
        return load_json(self.bench / "traffic" / (cell["traffic"] + ".json"))

    def limits(self, cell: Dict[str, Any]) -> Dict[str, float]:
        return load_json(self.bench / "limits" / (cell["name"] + ".json"))

    def metrics(self, cell: Dict[str, Any], trace: bool
                ) -> List[Dict[str, Any]]:
        """The cell's end-to-end metrics, or with ``trace`` its per-layer
        ones: those without a ``workloads`` key and those that list it."""
        entries = self.doc["per_layer" if trace else "end_to_end"]
        return [m for m in entries
                if cell["name"] in m.get("workloads", [cell["name"]])]

    def driver(self, traffic: Dict[str, Any]) -> ModuleType:
        return load_module(self.bench / "drivers" / (traffic["driver"]
                                                     + ".py"))

    def reader_path(self, metric: str) -> Path:
        path = self.bench / "metrics" / (metric + ".py")
        if not path.is_file() and "." in metric:
            path = self.bench / "metrics" / (metric.rsplit(".", 1)[0]
                                             + ".py")
        return path

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.reader_path(metric))

    def ops(self) -> Dict[str, ModuleType]:
        return {p.stem: load_module(p)
                for p in sorted((self.bench / "ops").glob("*.py"))}
