"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's files in
a temporary checkout, its traffic cut to a few small frames, run on the
CPU.  Tests that need the card are marked ``card`` and skip without one.

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# each traffic mix at a size the CPU runs in seconds
SMALL = {
    "kitti_frame_b1_closed": dict(height_width=[60, 90], pool_pairs=3,
                                  host_batches=3),
    "kitti_padded_b16_closed": dict(batch=3, height_width=[64, 128],
                                    pool_pairs=4),
    "kitti_crop_b4_steps": dict(batch=2, raw_height_width=[72, 136],
                                crop_height_width=[64, 128],
                                pool_batches=3),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture(autouse=True)
def program_env(monkeypatch):
    """The runs set the program's environment from their configuration;
    this restores it after each test."""
    monkeypatch.setenv("UPFLOW_ROBUST_MASK", "1")


def make_small_root(dest: Path) -> Path:
    dest.mkdir(parents=True, exist_ok=True)
    shutil.copytree(REPO / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", dest)
    (dest / "assets").symlink_to(REPO / "assets")
    for name, over in SMALL.items():
        path = dest / "benchmark" / "traffic" / (name + ".json")
        mix = json.loads(path.read_text())
        mix.update(over)
        path.write_text(json.dumps(mix))
    return dest


@pytest.fixture
def small_root(tmp_path) -> Path:
    return make_small_root(tmp_path / "checkout")


@pytest.fixture
def run_cell(capsys):
    """``run_cell(root, cell, trace=0, seed=..., seconds=1.0)``: (exit
    code, the result line as a dict, standard error) of one run of
    ``cell`` on the CPU in the checkout ``root``."""
    import time

    import torch

    from benchmark.core import runner

    def run(root: Path, cell: str, trace: int = 0, seed: int = 3000000017,
            seconds: float = 1.0):
        rc = runner.main(["--workload", cell, "--seed", str(seed),
                          "--seconds", str(seconds), "--trace", str(trace)],
                         time.perf_counter(), root=root,
                         device=torch.device("cpu"))
        out, err = capsys.readouterr()
        lines = out.strip().splitlines()
        return rc, (json.loads(lines[-1]) if rc == 0 else None), err

    return run
