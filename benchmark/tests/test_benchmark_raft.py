"""The RAFT cell (``serve_raft_bf16_kitti_b1``) on the CPU at a small size:
its reference against the program at fp32, its FLOP count at the cell's
size, a sound run correct and a run with a fault, the fp8 control or a
program without RAFT not; and its new metric readers, on hand-made
traces, None where the program has no RAFT spans or lookup."""

from __future__ import annotations

import json
import time
import types

import pytest
import torch

from conftest import REPO, make_small_root

from benchmark.core import runner
from benchmark.core.spec import Spec
from benchmark.core.trace import Trace
from benchmark.reference import raft as reference

CELL = "serve_raft_bf16_kitti_b1"
MIX = "raft_kitti_frame_b1_closed"
# 188 x 250 pads to a 24 x 32 grid, whose coarsest level is 3 x 4 (a frame
# of at most 120 rows or columns leaves it one pixel high or wide, where
# RAFT's sampler divides by 0); at 124 x 150 a pixel is 1/37,200 of the
# occlusion share, too coarse a step for the cell's limit, which holds
# the share at 375 x 1242 (PERF.md, section 4)
SMALL = dict(height_width=[188, 250], pool_pairs=3, host_batches=3)


@pytest.fixture
def raft_root(tmp_path):
    root = make_small_root(tmp_path / "checkout")
    path = root / "benchmark" / "traffic" / (MIX + ".json")
    mix = json.loads(path.read_text())
    mix.update(SMALL)
    path.write_text(json.dumps(mix))
    return root


def driver_of(root, seed=3000000019, iters=None):
    spec = Spec(root)
    cell = spec.cell(CELL)
    config = spec.config(cell)
    if iters is not None:
        config["raft"] = dict(config["raft"], iters=iters)
    run = runner.Run(seed, False, cell, config, spec.traffic(cell),
                     torch.device("cpu"))
    return spec.driver(run.traffic).Driver(run, root), spec.limits(cell)


def test_the_reference_is_the_program_at_fp32(raft_root):
    """The benchmark's reference and the program's fp32 entry on the same
    pairs and weights: the same flows (1e-4 px) and occlusion masks."""
    from upflow_pytorch_tpu_torch.models import upflow

    driver, _ = driver_of(raft_root, iters=3)
    driver.run.config["raft"]["compute_dtype"] = "float32"
    driver.setup()
    ids = [0, 1]
    ref = driver.reference_outputs(ids)
    for pid in ids:
        out = upflow.forward(driver.model, driver.pool["im1"][pid:pid + 1],
                             driver.pool["im2"][pid:pid + 1])
        for key in ("flow_f_out", "flow_b_out"):
            epe = float((out[key][0] - ref[pid][key]).norm(dim=-1).mean())
            assert epe <= 1e-4, (pid, key, epe)
        for key in ("occ_fw", "occ_bw"):
            assert float((out[key][0] != ref[pid][key]).float().mean()
                         ) <= 1e-3


def test_the_weights_are_drawn_by_the_benchmark(raft_root):
    """The program serves the state dict that ``reference/raft.py::
    init_params`` draws from the seed, not its own initialisation; the
    seed decides the draw."""
    from upflow_pytorch_tpu_torch.models import upflow

    driver, _ = driver_of(raft_root, iters=1)
    driver.setup()
    served = driver.model.state_dict()
    assert set(served) == set(driver.params)
    for k, v in driver.params.items():
        assert torch.equal(served[k].cpu(), v), k
    own = upflow.build_model(driver.conf, "cpu", seed=driver.run.seed)
    w = "update_block.flow_head.conv2.weight"
    assert not torch.equal(own.state_dict()[w], driver.params[w])
    again = reference.init_params(driver.run.seed, driver.run.config)
    other = reference.init_params(driver.run.seed + 1, driver.run.config)
    assert torch.equal(again[w], driver.params[w])
    assert not torch.equal(other[w], driver.params[w])


def test_flops_at_the_cells_size():
    """2.63 TFLOP a pair at 375 x 1242 (both directions, 24 iterations);
    23 more iterations add 23 x 2 x 45.7 GFLOP of the update block (per
    pixel of the 47 x 156 grid 3,118,336 multiply-adds)."""
    spec = Spec(REPO)
    driver, _ = driver_of(REPO)
    from upflow_pytorch_tpu_torch.config import RAFTConfig

    driver.conf = RAFTConfig().updated(driver.run.config["raft"])
    driver.params = reference.init_params(5, driver.run.config)
    full = driver.flops_per_unit()
    driver.conf = driver.conf.updated({"iters": 1})
    one = driver.flops_per_unit()
    assert full == 2632593899520
    assert full - one == 23 * 2 * 2 * 3118336 * 47 * 156
    assert spec.config(spec.cell(CELL))["parameters"] == sum(
        v.numel() for k, v in driver.params.items()
        if not k.endswith(("running_mean", "running_var",
                           "num_batches_tracked"))
        and ".downsample.1." not in k)


def test_a_sound_run_is_correct(raft_root, run_cell):
    rc, result, _ = run_cell(raft_root, CELL, seconds=1.0)
    assert rc == 0 and result["correct"], result["checks"]
    assert set(result["metrics"]) == {"setup_s", "serve_latency_p95_ms"}


def test_an_altered_flow_is_not(raft_root, run_cell, monkeypatch):
    from upflow_pytorch_tpu_torch.models import upflow

    forward = upflow.forward

    def wrong(*args, **kwargs):
        out = forward(*args, **kwargs)
        out["flow_f_out"] = out["flow_f_out"] + 2.0
        return out

    monkeypatch.setattr(upflow, "forward", wrong)
    rc, result, _ = run_cell(raft_root, CELL, seconds=1.0)
    assert rc == 0 and not result["correct"], result["checks"]


def test_the_control_fails_a_limit(raft_root):
    driver, limits = driver_of(raft_root)
    driver.setup()
    driver.window(1.0)
    driver.release()
    assert all(c.ok for c in driver.judge(limits))
    numbers = driver.control()
    assert any(numbers[k] > limits[k] for k in limits), numbers


def test_a_program_without_raft_fails_in_set_up(raft_root, monkeypatch):
    """The parent of the commit that added RAFT has no ``RAFTConfig``: its
    run raises in set-up, before any window."""
    from upflow_pytorch_tpu_torch import config

    monkeypatch.delattr(config, "RAFTConfig")
    with pytest.raises(ImportError):
        runner.main(["--workload", CELL, "--seed", "5", "--seconds", "1",
                     "--trace", "0"], time.perf_counter(), root=raft_root,
                    device=torch.device("cpu"))


# --- the readers -------------------------------------------------------------

def trace(launched, op_calls=(), op_device_s=None, units=2):
    return Trace(wall_s=1.0, busy_s=0.5, calls=units, units=units,
                 launched=list(launched), by_name={},
                 op_device_s=dict(op_device_s or {}), gaps={},
                 op_calls=list(op_calls))


def read(name, t):
    return Spec(REPO).reader(name).read(types.SimpleNamespace(trace=t))


# two requests of RAFT: each operation with the host op that launched it
# and that op's ancestors, innermost first
RAFT = trace(
    launched=[
        ("gemm", 0.0006, ("aten::bmm", "upflow.raft.corr_volume",
                          "upflow.forward")),
        ("avg_pool2d", 0.0002, ("aten::avg_pool2d",
                                "upflow.raft.corr_volume", "upflow.forward")),
        ("corr_lookup_kernel<bf16>", 0.00005,
         ("upflow.kernel.corr_lookup", "upflow.raft.lookup",
          "upflow.forward")),
        ("conv3x3_seg_kernel", 0.004,
         ("upflow.kernel.conv3x3_seg", "upflow.raft.update",
          "upflow.forward")),
        ("cudnn_conv", 0.006, ("aten::cudnn_convolution", "aten::conv2d",
                               "upflow.raft.update", "upflow.forward")),
    ],
    # one lookup of 2 x 47 x 156 pixels: bytes and operations as the op
    # file counts them (the 5 x 19 level gives 5 x 10 of the footprint),
    # its kernel 100 us
    op_calls=[("corr_lookup", 14664 * (8 + 1400 + 648),
               14664 * 324 * 7, "float32")],
    op_device_s={"corr_lookup": 1e-4})
BARE = trace(launched=[("gemm", 0.0006, ("aten::bmm", "upflow.forward"))],
             op_calls=[("conv3x3_seg", 1e6, 1e9, "bfloat16")],
             op_device_s={"conv3x3_seg": 1e-3})


@pytest.mark.parametrize("name,want", [
    # (4 + 6) ms under upflow.raft.update over 2 pairs
    ("raft_update_device_ms.raft_b1", 5.0),
    # (0.6 + 0.2) ms under upflow.raft.corr_volume over 2 pairs
    ("corr_volume_device_ms.raft_b1", 0.4),
    # 30.15 MB over 3.35 TB/s in 100 us
    ("corr_lookup_roofline.raft_b1",
     100.0 * 14664 * 2056 / 3.35e12 / 1e-4),
])
def test_reads_the_value_worked_by_hand(name, want):
    assert read(name, RAFT) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", ["raft_update_device_ms.raft_b1",
                                  "corr_volume_device_ms.raft_b1",
                                  "corr_lookup_roofline.raft_b1"])
def test_none_without_raft(name):
    assert read(name, BARE) is None
    assert read(name, None) is None


def test_the_lookups_cost_is_the_wrappers_call():
    """``benchmark/ops/corr_lookup.py`` takes the program's call as it is
    made: the 4 levels, the coordinates and the output dtype."""
    op = Spec(REPO).ops()["corr_lookup"]
    levels = [torch.empty(14664, 1, h, w, device="meta")
              for h, w in ((47, 156), (23, 78), (11, 39), (5, 19))]
    coords = torch.empty(2, 2, 47, 156, device="meta")
    assert op.cost(levels, coords, torch.bfloat16) == (
        14664 * (8 + 1400 + 648), 14664 * 324 * 7, "float32")
    # at a grid whose levels all hold the whole footprint, 400 B each
    small = [torch.empty(1, 1, 80 >> i, 90 >> i, device="meta")
             for i in range(3)]
    assert op.cost(small, torch.empty(1, 2, 80, 90, device="meta"),
                   torch.float32)[0] == 80 * 90 * (8 + 3 * 400 + 3 * 81 * 4)
    assert op.TARGET == \
        "upflow_pytorch_tpu_torch.ops.kernels.corr_lookup:_corr_lookup"
