"""A run's ``correct`` comes out false when the timed path is broken
underneath, once for each fault the cells can have (the look for a card
skipped, the rest of a run driven on the CPU at a small size); sound runs
come out true; and a run without the card or without the program prints
no result."""

from __future__ import annotations

import shutil
import subprocess
import sys

import pytest
import torch

from conftest import REPO


@pytest.mark.parametrize("cell", ["serve_bf16_kitti_b1",
                                  "serve_bf16_kitti_b16",
                                  "train_fp32_kitti_b4"])
def test_sound_runs_are_correct(small_root, run_cell, cell):
    rc, result, _ = run_cell(small_root, cell)
    assert rc == 0 and result["correct"], result["checks"]


def altered_forward(monkeypatch):
    """Every served flow altered by 0.5 px where the entry produces it."""
    from upflow_pytorch_tpu_torch.models import upflow

    forward = upflow.forward

    def wrong(*args, **kwargs):
        out = forward(*args, **kwargs)
        out["flow_f_out"] = out["flow_f_out"] + 0.5
        return out

    monkeypatch.setattr(upflow, "forward", wrong)


def unchanged_state(monkeypatch):
    """The optimizer's step returns with the state unchanged."""
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)


def unchanged_in_the_window(monkeypatch):
    """The optimizer's step leaves the state unchanged from its fourth
    call on: set-up's three steps are sound, the window's are not."""
    step = torch.optim.Adam.step
    count = [0]

    def after_three(self, closure=None):
        count[0] += 1
        if count[0] <= 3:
            return step(self, closure)
        return None

    monkeypatch.setattr(torch.optim.Adam, "step", after_three)


def half_batch(monkeypatch):
    """The step's loss over the first half of the batch alone."""
    from upflow_pytorch_tpu_torch.train import step

    forward_with_loss = step.forward_with_loss

    def half(model, batch):
        n = batch["im1"].shape[0] // 2
        return forward_with_loss(model, {k: v[:n] for k, v in batch.items()})

    monkeypatch.setattr(step, "forward_with_loss", half)


def altered_loss(monkeypatch):
    """The step's loss altered by 1% where it is produced."""
    from upflow_pytorch_tpu_torch.train import step

    forward_with_loss = step.forward_with_loss

    def wrong(model, batch):
        out = forward_with_loss(model, batch)
        out["total_loss"] = out["total_loss"] * 1.01
        return out

    monkeypatch.setattr(step, "forward_with_loss", wrong)


@pytest.mark.parametrize("cell,fault", [
    ("serve_bf16_kitti_b1", altered_forward),
    ("serve_bf16_kitti_b16", altered_forward),
    ("train_fp32_kitti_b4", unchanged_state),
    ("train_fp32_kitti_b4", unchanged_in_the_window),
    ("train_fp32_kitti_b4", half_batch),
    ("train_fp32_kitti_b4", altered_loss),
], ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_a_broken_timed_path_is_not_correct(small_root, run_cell,
                                            monkeypatch, cell, fault):
    fault(monkeypatch)
    rc, result, err = run_cell(small_root, cell)
    assert rc == 0 and result["correct"] is False, result["checks"]
    assert "FAILED" in err


def test_without_a_card_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, str(REPO / "benchmark" / "run.py"), "--workload",
         "serve_bf16_kitti_b1", "--seed", "2147483649", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=REPO,
        timeout=300)
    assert proc.returncode == 2 and proc.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    code = ("import sys, time, torch; sys.path[:0] = [%r]; "
            "from benchmark.core import runner; "
            "sys.exit(runner.main(['--workload', 'serve_bf16_kitti_b1', "
            "'--seed', '7', '--seconds', '1'], time.perf_counter(), "
            "device=torch.device('cpu')))" % str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=tmp_path, timeout=300)
    assert proc.returncode != 0
    assert not any(line.startswith("{") for line in
                   proc.stdout.splitlines())
    assert "upflow_pytorch_tpu_torch" in proc.stderr


def test_jax_loaded_after_the_window_no_result(small_root, run_cell,
                                               monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", object())
    rc, result, err = run_cell(small_root, "serve_bf16_kitti_b1")
    assert rc == 3 and result is None and "jax" in err
