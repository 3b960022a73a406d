"""On the card, at each cell's own size: the control (the reference in the
precision below the configuration's, in the program's place) fails one of
the cell's limits, and a short run of the program passes them all.

    python -m pytest benchmark/tests/test_benchmark_card.py -q -m card
"""

from __future__ import annotations

import pytest
import torch

from conftest import REPO

from benchmark.core.runner import Run
from benchmark.core.spec import Spec

CELLS = [c["name"] for c in Spec(REPO).doc["workloads"]]


def short_run(cell: str, seed: int):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = Spec(REPO)
    entry = spec.cell(cell)
    run = Run(seed, False, entry, spec.config(entry), spec.traffic(entry),
              torch.device("cuda", 0))
    driver = spec.driver(run.traffic).Driver(run, REPO)
    driver.setup()
    driver.window(2.0)
    driver.release()
    return driver, spec.limits(entry)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_a_limit(cell):
    driver, limits = short_run(cell, 2147483777)
    numbers = driver.control()
    assert any(numbers[k] > limits[k] for k in limits), numbers


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_program_passes_every_limit(cell):
    driver, limits = short_run(cell, 2147483778)
    checks = driver.judge(limits)
    assert all(c.ok for c in checks), checks
