"""The per-layer metrics that read the program's own spans (``upflow.*``),
each on a hand-made trace whose value is worked by hand, and None on a
trace of a program without the spans."""

from __future__ import annotations

import types

import pytest

from conftest import REPO

from benchmark.core.spec import Spec
from benchmark.core.trace import Trace

SPEC = Spec(REPO)
PROGRAM_SPAN = [m["name"] for m in SPEC.doc["per_layer"]
                if m["source"] == "program_span"]


def trace(launched, gaps, calls=2, units=2):
    return Trace(wall_s=1.0, busy_s=0.5, calls=calls, units=units,
                 launched=launched, by_name={}, op_device_s={}, gaps=gaps,
                 op_calls=[])


def read(name, t):
    return SPEC.reader(name).read(types.SimpleNamespace(trace=t))


# two B=1 requests: each operation with the host op that launched it and
# that op's ancestors, innermost first
SERVED = trace(
    launched=[
        ("Memcpy HtoD (Pageable -> Device)", 0.004,
         ("aten::copy_", "aten::_to_copy", "aten::to", "upflow.copy_in",
          "upflow.forward")),
        ("elementwise_kernel", 0.0002,
         ("aten::copy_", "aten::contiguous", "upflow.copy_in",
          "upflow.forward")),
        ("conv3x3_seg_kernel", 0.001,
         ("upflow.kernel.conv3x3_seg", "upflow.level.0", "upflow.forward")),
        ("nchwToNhwcKernel", 0.0003,
         ("aten::cudnn_convolution", "aten::convolution", "upflow.pyramid",
          "upflow.forward")),
        ("elementwise_kernel", 0.0003,
         ("aten::copy_", "aten::contiguous", "upflow.copy_out",
          "upflow.forward")),
        ("Memset (Device)", 0.0001, ("aten::zero_",)),
    ],
    gaps={"upflow.level.3": 0.003, "upflow.kernel.warp": 0.001,
          "cudaLaunchKernel": 0.010, "host idle": 0.002})

# one training step
STEPPED = trace(
    launched=[
        ("indexing_backward_kernel", 0.002,
         ("aten::index_put_", "upflow.rule.FeatureWarpFn",
          "autograd::engine::evaluate_function: FeatureWarpFnBackward")),
        ("elementwise_kernel", 0.001, ("aten::mul", "upflow.rule.SguFinalFn")),
        ("wgrad_alg1_engine", 0.005,
         ("aten::convolution_backward",
          "autograd::engine::evaluate_function: ConvolutionBackward0")),
        ("multi_tensor_apply_kernel", 0.0005,
         ("aten::_foreach_add_", "Optimizer.step#Adam.step",
          "upflow.step.optimizer", "upflow.step")),
    ],
    gaps={"upflow.rule.FeatureWarpFn": 0.020, "upflow.step.loss": 0.005,
          "aten::mul": 0.004}, calls=1, units=1)

# the same operations as a program without spans shows them
BARE = trace(
    launched=[("Memcpy HtoD (Pageable -> Device)", 0.004,
               ("aten::copy_", "aten::_to_copy", "aten::to")),
              ("conv3x3_seg_kernel", 0.001, ()),
              ("indexing_backward_kernel", 0.002,
               ("aten::index_put_", "bench_bwd::FeatureWarpFn"))],
    gaps={"cudaLaunchKernel": 0.010, "bench_bwd::FeatureWarpFn": 0.02,
          "host idle": 0.002})


@pytest.mark.parametrize("name,t,want", [
    # (4 + 0.2 + 0.3) ms of copy_in and copy_out over 2 pairs
    ("entry_copy_device_ms.serve", SERVED, 2.25),
    ("entry_copy_device_ms.serve_b1", SERVED, 2.25),
    # 5 operations under upflow.forward over 2 requests
    ("device_ops.serve_b1", SERVED, 2.5),
    # (3 + 1) ms of gaps labelled upflow.* over 2 requests
    ("idle_in_program_ms.serve_b1", SERVED, 2.0),
    # 20 + 5 ms over 1 step
    ("idle_in_program_ms.train", STEPPED, 25.0),
    # (2 + 1) ms under upflow.rule.* over 1 step
    ("rule_device_ms.train", STEPPED, 3.0),
])
def test_reads_the_value_worked_by_hand(name, t, want):
    assert read(name, t) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", PROGRAM_SPAN)
def test_none_without_the_programs_spans(name):
    """A parent without spans reports nothing rather than 0, and so does
    a run without a trace."""
    assert read(name, BARE) is None
    assert read(name, None) is None


def test_the_six_entries_read_spans():
    assert PROGRAM_SPAN == [
        "entry_copy_device_ms.serve", "entry_copy_device_ms.serve_b1",
        "device_ops.serve_b1", "idle_in_program_ms.serve_b1",
        "idle_in_program_ms.train", "rule_device_ms.train"]
    for name in PROGRAM_SPAN:
        assert SPEC.reader_path(name).parent == REPO / "benchmark" / "metrics"
