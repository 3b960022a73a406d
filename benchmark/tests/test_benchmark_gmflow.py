"""The GMFlow cell (``serve_gmflow_bf16_kitti_b1``) on the CPU at a small
size: its reference against the program at fp32, the weights drawn by the
benchmark, its FLOP count at the cell's size, a sound run correct and a
run with a fault, the fp8 control or a program without GMFlow not, the
planted faults of ``benchmark/tools/gmflow_faults.py`` well apart from a
sound run; and its
new metric readers, on hand-made traces, None where the program has no
GMFlow spans or matching kernel; the op's cost against the wrapper's
call."""

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
from benchmark.reference import gmflow as reference
from benchmark.tools.gmflow_faults import FAULTS, planted

CELL = "serve_gmflow_bf16_kitti_b1"
MIX = "gmflow_kitti_frame_b1_closed"
# 124 x 150 pads to 128 x 160: a 16 x 20 grid in 2 x 2 windows of 8 x 10,
# whose shifted blocks roll by (4, 5)
SMALL = dict(height_width=[124, 150], pool_pairs=3, host_batches=3)


@pytest.fixture
def gmflow_root(tmp_path):
    root = make_small_root(tmp_path / "checkout")
    path = root / "benchmark" / "traffic" / (MIX + ".json")
    mix = json.loads(path.read_text())
    mix.update(SMALL)
    path.write_text(json.dumps(mix))
    return root


def driver_of(root, seed=3000000019, dtype=None):
    spec = Spec(root)
    cell = spec.cell(CELL)
    config = spec.config(cell)
    if dtype is not None:
        config["gmflow"] = dict(config["gmflow"], compute_dtype=dtype)
    run = runner.Run(seed, False, cell, config, spec.traffic(cell),
                     torch.device("cpu"))
    return spec.driver(run.traffic).Driver(run, root), spec.limits(cell)


def test_the_reference_is_the_program_at_fp32(gmflow_root):
    """The benchmark's reference and the program's fp32 entry on the same
    pairs and weights: the same flows (1e-3 px, the global softmax over
    another order of fp32 sums) and occlusion masks."""
    from upflow_pytorch_tpu_torch.models import upflow

    driver, _ = driver_of(gmflow_root, dtype="float32")
    driver.setup()
    ids = [0, 1]
    ref = driver.reference_outputs(ids)
    for pid in ids:
        out = upflow.forward(driver.model, driver.pool["im1"][pid:pid + 1],
                             driver.pool["im2"][pid:pid + 1])
        for key in ("flow_f_out", "flow_b_out"):
            epe = float((out[key][0] - ref[pid][key]).norm(dim=-1).mean())
            assert epe <= 1e-3, (pid, key, epe)
        for key in ("occ_fw", "occ_bw"):
            assert float((out[key][0] != ref[pid][key]).float().mean()
                         ) <= 1e-3


def test_the_weights_are_drawn_by_the_benchmark(gmflow_root):
    """The program serves the state dict that ``reference/gmflow.py::
    init_params`` draws from the seed, not its own initialisation; the
    seed decides the draw; the key set is the program's; the layer norms'
    weights and the backbone's output conv carry the draw's gains."""
    from upflow_pytorch_tpu_torch.models import upflow

    driver, _ = driver_of(gmflow_root)
    driver.setup()
    served = driver.model.state_dict()
    assert set(served) == set(driver.params)
    for k, v in driver.params.items():
        assert torch.equal(served[k].cpu(), v), k
    own = upflow.build_model(driver.conf, "cpu", seed=driver.run.seed)
    w = "transformer.layers.4.cross_attn_ffn.mlp.2.weight"
    assert not torch.equal(own.state_dict()[w], driver.params[w])
    again = reference.init_params(driver.run.seed, driver.run.config)
    other = reference.init_params(driver.run.seed + 1, driver.run.config)
    assert torch.equal(again[w], driver.params[w])
    assert not torch.equal(other[w], driver.params[w])
    ln = driver.params["transformer.layers.0.self_attn.norm1.weight"]
    assert torch.equal(ln, torch.full((128,), reference.NORM_GAIN))
    assert not driver.params["transformer.layers.0.self_attn.norm1.bias"].any()
    # the bias: PyTorch's default bound 1 / sqrt(128), times the gain
    bias = driver.params["backbone.conv2.bias"]
    assert 0 < float(bias.abs().max()) <= reference.FEATURE_GAIN / 128 ** 0.5


def test_flops_at_the_cells_size():
    """454.6 GFLOP a pair at 375 x 1242 (both directions; the 48 x 156 grid
    of the frame padded to 384 x 1248), as FlopCounterMode counts the
    reference's convs and products; the parameters the configuration
    states."""
    spec = Spec(REPO)
    driver, _ = driver_of(REPO)
    driver.params = reference.init_params(5, driver.run.config)
    assert driver.flops_per_unit() == 454564970496
    assert spec.config(spec.cell(CELL))["parameters"] == sum(
        v.numel() for v in driver.params.values()) == 4680288


def test_a_sound_run_is_correct(gmflow_root, run_cell):
    rc, result, _ = run_cell(gmflow_root, CELL, seconds=1.0)
    assert rc == 0 and result["correct"], result["checks"]
    assert set(result["metrics"]) == {"setup_s", "serve_latency_p95_ms"}


@pytest.mark.parametrize("fault", ["shifted", "zeros"])
def test_an_altered_flow_is_not(gmflow_root, run_cell, monkeypatch, fault):
    """A forward flow moved by twice the px limit on every pair, or flows
    of zeros (the occlusion check then finds every pixel visible), fail
    the check."""
    from upflow_pytorch_tpu_torch.models import upflow

    forward = upflow.forward
    limits = Spec(REPO).limits(Spec(REPO).cell(CELL))
    shift = 2 * limits["median_pair_epe_px"]

    def wrong(*args, **kwargs):
        out = forward(*args, **kwargs)
        if fault == "shifted":
            out["flow_f_out"] = out["flow_f_out"] + shift
        else:
            for key in ("flow_f_out", "flow_b_out"):
                out[key] = torch.zeros_like(out[key])
            for key in ("occ_fw", "occ_bw"):
                out[key] = torch.ones_like(out[key])
        return out

    monkeypatch.setattr(upflow, "forward", wrong)
    rc, result, _ = run_cell(gmflow_root, CELL, seconds=1.0)
    assert rc == 0 and not result["correct"], result["checks"]


def test_the_control_fails_a_limit(gmflow_root):
    """The program passes each limit and the fp8 control fails one."""
    driver, limits = driver_of(gmflow_root)
    driver.setup()
    driver.window(1.0)
    driver.release()
    assert all(c.ok for c in driver.judge(limits))
    numbers = driver.control()
    assert any(numbers[k] > limits[k] for k in limits), numbers


@pytest.mark.parametrize("fault", FAULTS)
def test_a_planted_fault_moves_the_flows(gmflow_root, fault):
    """Each fault of ``benchmark/tools/gmflow_faults.py``, planted in the
    program, parts its flows from the reference's by at least 3 times as
    much as the sound program's on the same seed (the cell's limits are
    set from these readings at the cell's size on the card); the program
    gives its own flows again after the block."""
    from upflow_pytorch_tpu_torch.models import upflow

    def reading():
        driver, limits = driver_of(gmflow_root)
        driver.setup()
        driver.window(0.5)
        driver.release()
        return {c.name: c.value
                for c in driver.judge(limits)}["median_pair_epe_px"]

    sound = reading()
    with planted(fault):
        assert reading() >= 3 * sound
    driver, _ = driver_of(gmflow_root)
    driver.setup()
    pair = (driver.pool["im1"][:1], driver.pool["im2"][:1])
    before = upflow.forward(driver.model, *pair)["flow_f_out"]
    with planted(fault):
        during = upflow.forward(driver.model, *pair)["flow_f_out"]
    after = upflow.forward(driver.model, *pair)["flow_f_out"]
    assert not torch.equal(during, before)
    assert torch.equal(after, before)


def test_a_program_without_gmflow_fails_in_set_up(gmflow_root, monkeypatch):
    """The parent of the commit that added GMFlow has no ``GMFlowConfig``:
    its run raises in set-up, before any window."""
    from upflow_pytorch_tpu_torch import config

    monkeypatch.delattr(config, "GMFlowConfig")
    with pytest.raises(ImportError):
        runner.main(["--workload", CELL, "--seed", "5", "--seconds", "1",
                     "--trace", "0"], time.perf_counter(), root=gmflow_root,
                    device=torch.device("cpu"))


# --- the readers -------------------------------------------------------------

def trace(launched, op_calls=(), op_device_s=None, units=2):
    return Trace(wall_s=1.0, busy_s=0.5, calls=units, units=units,
                 launched=list(launched), by_name={},
                 op_device_s=dict(op_device_s or {}), gaps={},
                 op_calls=list(op_calls))


def read(name, t):
    return Spec(REPO).reader(name).read(types.SimpleNamespace(trace=t))


# two requests of GMFlow: each operation with the host op that launched it
# and that op's ancestors, innermost first
N, L = 2, 7488
MATCH_BYTES = 2 * N * L * 128 * 2 + N * L * 2 * 4 + N * L * 2 * 4
MATCH_OPS = 2 * N * L * L * 128
GMFLOW = trace(
    launched=[
        ("cudnn_conv", 0.002, ("aten::cudnn_convolution", "aten::conv2d",
                               "upflow.gmflow.encoder", "upflow.forward")),
        ("fmha_cutlass", 0.003, ("aten::_efficient_attention_forward",
                                 "aten::scaled_dot_product_attention",
                                 "upflow.gmflow.transformer",
                                 "upflow.forward")),
        ("gemm", 0.001, ("aten::mm", "aten::linear",
                         "upflow.gmflow.transformer", "upflow.forward")),
        ("global_match_kernel", 0.0002,
         ("upflow.kernel.global_match", "upflow.gmflow.match",
          "upflow.forward")),
        ("elementwise", 0.00001, ("aten::sub", "upflow.gmflow.match",
                                  "upflow.forward")),
        ("gemm", 0.00003, ("aten::mm", "aten::linear",
                           "upflow.gmflow.propagate", "upflow.forward")),
        ("global_match_kernel", 0.0002,
         ("upflow.kernel.global_match", "upflow.gmflow.propagate",
          "upflow.forward")),
    ],
    # the two calls of the two requests, their kernel 400 us in all
    op_calls=[("global_match", MATCH_BYTES, MATCH_OPS, "bfloat16")] * 4,
    op_device_s={"global_match": 4e-4})
BARE = trace(launched=[("gemm", 0.0006, ("aten::bmm", "upflow.forward"))],
             op_calls=[("conv3x3_seg", 1e6, 1e9, "bfloat16")],
             op_device_s={"conv3x3_seg": 1e-3})


@pytest.mark.parametrize("name,want", [
    # (3 + 1) ms under upflow.gmflow.transformer over 2 pairs
    ("transformer_device_ms.gmflow_b1", 2.0),
    # (0.2 + 0.01 + 0.03 + 0.2) ms under the match and propagate spans
    ("global_match_device_ms.gmflow_b1", 0.22),
    # 4 calls of 28.7 GFLOP over 989 TFLOP/s (the bytes take less) in
    # 400 us
    ("global_match_roofline.gmflow_b1",
     100.0 * 4 * MATCH_OPS / 989e12 / 4e-4),
])
def test_reads_the_value_worked_by_hand(name, want):
    assert read(name, GMFLOW) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", ["transformer_device_ms.gmflow_b1",
                                  "global_match_device_ms.gmflow_b1",
                                  "global_match_roofline.gmflow_b1"])
def test_none_without_gmflow(name):
    assert read(name, BARE) is None
    assert read(name, None) is None


def test_the_ops_cost_is_the_wrappers_call():
    """``benchmark/ops/global_match.py`` takes the program's call as it is
    made: q, k (bf16), v (fp32) and the scale; its operations are the q
    k^T products alone."""
    op = Spec(REPO).ops()["global_match"]
    q = torch.empty(N, L, 128, dtype=torch.bfloat16, device="meta")
    v = torch.empty(N, L, 2, device="meta")
    assert op.cost(q, q, v, 0.0884) == (MATCH_BYTES, MATCH_OPS, "bfloat16")
    k = torch.empty(3, 77, 128, dtype=torch.bfloat16, device="meta")
    small = op.cost(torch.empty(3, 100, 128, dtype=torch.bfloat16,
                                device="meta"), k,
                    torch.empty(3, 77, 2, device="meta"), 1.0)
    assert small == (3 * (100 + 77) * 256 + 3 * 77 * 8 + 3 * 100 * 8,
                     2 * 3 * 100 * 77 * 128, "bfloat16")
    assert op.TARGET == \
        "upflow_pytorch_tpu_torch.ops.kernels.global_match:_global_match"
