"""The port's own spans (``utils/profiling.py::span``), on the CPU.

While a torch profiler records, the entry, the network, the training step,
each kernel launch and each kernel op's gradient rule open host ranges
named ``upflow.*``; the benchmark's per-layer metrics read them.  Here: the
serving and training spans, nested as ``span``'s docstring gives them, the
kernel span around a launch through the C library (the library stubbed),
outputs and a step's parameters bit-equal with the profiler on and off,
the off path (one shared null context, no range opened), the names clear of
the substrings the benchmark's older metrics match, and every kernel op's
``backward`` still a ``staticmethod``.
"""

import ast
import inspect
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from upflow_pytorch_tpu_torch.config import TrainerConfig, UPFlowConfig
from upflow_pytorch_tpu_torch.data.synthetic import make_dataset
from upflow_pytorch_tpu_torch.models import upflow as pupflow
from upflow_pytorch_tpu_torch.ops.kernels import (
    _common, conv3x3_seg, corr_norm, correlation, feature_warp, sgu_blend,
    sgu_final, warp)
from upflow_pytorch_tpu_torch.train import step as pstep
from upflow_pytorch_tpu_torch.utils import profiling

PACKAGE = Path(pupflow.__file__).resolve().parents[1]
KERNEL_MODULES = (conv3x3_seg, corr_norm, correlation, feature_warp,
                  sgu_blend, sgu_final, warp)

# the training recipe of the determinism tests (SGU, the normalised cost
# volume, census, the distillation) on B=2 64x128 crops
KNOBS = dict(if_norm_before_cost_volume=True,
             norm_moments_across_channels=False,
             norm_moments_across_images=False, if_sgu_upsample=True,
             photo_loss_census_weight=1.0,
             multi_scale_distillation_weight=0.01,
             multi_scale_distillation_style="upup",
             multi_scale_distillation_occ=True, stop_occ_gradient=True)
SHAPE, RAW = (2, 64, 128), (80, 144)

# each serving span and its nearest ``upflow.*`` ancestor, in the order
# they open in one request
SERVING = [("upflow.forward", None), ("upflow.copy_in", "upflow.forward"),
           ("upflow.pyramid", "upflow.forward")] + [
    ("upflow.level.%d" % i, "upflow.forward") for i in range(5)] + [
    ("upflow.upsample", "upflow.forward"),
    ("upflow.occlusion", "upflow.forward"),
    ("upflow.copy_out", "upflow.forward")]
STEP = {"upflow.step": None, "upflow.step.loss": "upflow.step",
        "upflow.step.equivariance": "upflow.step",
        "upflow.step.backward": "upflow.step",
        "upflow.step.optimizer": "upflow.step"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def owner(e):
    """The name of the nearest ``upflow.*`` ancestor of the event ``e``."""
    p = e.cpu_parent
    while p is not None and not p.name.startswith("upflow."):
        p = p.cpu_parent
    return None if p is None else p.name


def spans(events):
    return sorted((e for e in events if e.name.startswith("upflow.")),
                  key=lambda e: e.time_range.start)


def profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, spans(prof.events())


def pair(seed=0, hw=(64, 128)):
    rng = np.random.default_rng(seed)
    return [rng.random((1,) + hw + (3,), dtype=np.float32)
            for _ in range(2)]


@pytest.fixture(scope="module")
def batch():
    b, h, w = SHAPE
    data = make_dataset(b, seed=5, raw_hw=RAW, crop_hw=(h, w))
    return {k: torch.from_numpy(v) for k, v in data.items()
            if k != "gt_flow"}


@pytest.fixture(scope="module")
def profiled_steps(batch):
    """``train_run(batch, eq_weight, on=True)`` by ``eq_weight``, each run
    once for the module."""
    runs = {}

    def get(eq_weight):
        if eq_weight not in runs:
            runs[eq_weight] = train_run(batch, eq_weight, on=True)
        return runs[eq_weight]

    return get


def train_run(batch, eq_weight, on):
    """One step from seeded weights, under the profiler when ``on``:
    (metrics, parameters after it, the spans recorded)."""
    conf = UPFlowConfig().updated(KNOBS)
    model, state, opt = pstep.create_train_state(conf, TrainerConfig(),
                                                 device="cpu", seed=0)
    step_fn = pstep.make_train_step(model, opt, eq_loss_weight=eq_weight)
    if on:
        (_, metrics), events = profiled(lambda: step_fn(state, batch))
    else:
        (_, metrics), events = step_fn(state, batch), []
    return metrics, {n: p.detach().clone()
                     for n, p in model.named_parameters()}, events


@pytest.mark.parametrize("sgu", [True, False], ids=["sgu", "bilinear"])
def test_forward_holds_every_serving_span_nested(sgu):
    """One request opens each serving span once, in order, under
    ``upflow.forward``; the final stage is ``upflow.upsample`` with SGU and
    without it."""
    conf = UPFlowConfig().updated(dict(KNOBS, if_sgu_upsample=sgu))
    model = pupflow.build_model(conf, "cpu", seed=0)
    _, events = profiled(lambda: pupflow.forward(model, *pair()))
    assert [(e.name, owner(e)) for e in events] == SERVING


@pytest.mark.parametrize("eq_weight", [0.0, 0.1])
def test_train_step_holds_its_phases(profiled_steps, eq_weight):
    """A step opens ``upflow.step`` over its loss, backward and optimizer
    phases, and the equivariance phase when its weight is above 0; the
    network's spans lie under the teacher's and the student's forwards,
    and on the CPU, where autograd runs the backward on the calling
    thread, every gradient rule's span lies under the backward."""
    _, _, events = profiled_steps(eq_weight)
    phases = [(e.name, owner(e)) for e in events if e.name in STEP]
    want = [n for n in STEP if eq_weight > 0 or "equivariance" not in n]
    assert sorted(phases) == sorted((n, STEP[n]) for n in want)
    forwards = ["upflow.step.loss"] + (
        ["upflow.step.equivariance"] if eq_weight > 0 else [])
    pyramids = [owner(e) for e in events if e.name == "upflow.pyramid"]
    assert pyramids == forwards
    rules = [e for e in events if e.name.startswith("upflow.rule.")]
    assert {e.name for e in rules} >= {
        "upflow.rule.FeatureWarpFn", "upflow.rule.CorrNormFn",
        "upflow.rule.SguBlendPairFn", "upflow.rule.SguFinalFn"}
    assert {owner(e) for e in rules} == {"upflow.step.backward"}


def test_forward_bit_equal_with_the_profiler_on_and_off():
    model = pupflow.build_model(UPFlowConfig().updated(KNOBS), "cpu",
                                seed=0)
    im1, im2 = pair(3)
    off = pupflow.forward(model, im1, im2)
    on, events = profiled(lambda: pupflow.forward(model, im1, im2))
    assert events
    for key in ("flow_f_out", "flow_b_out", "occ_fw", "occ_bw"):
        assert torch.equal(on[key], off[key]), key


@pytest.mark.parametrize("eq_weight", [0.0, 0.1])
def test_step_bit_equal_with_the_profiler_on_and_off(batch, profiled_steps,
                                                     eq_weight):
    m_off, p_off, _ = train_run(batch, eq_weight, on=False)
    m_on, p_on, events = profiled_steps(eq_weight)
    assert events
    assert set(m_on) == set(m_off)
    for key in m_off:
        assert torch.equal(m_on[key], m_off[key]), key
    for name in p_off:
        assert torch.equal(p_on[name], p_off[name]), name


def test_off_path_is_one_null_context_and_opens_no_range(monkeypatch):
    """Outside a profiler ``span`` hands out the same null object, and a
    whole request opens no range."""
    assert not torch.autograd.profiler._is_profiler_enabled
    first = profiling.span("upflow.forward")
    assert profiling.span("upflow.level.", 3) is first
    assert profiling.span("upflow.kernel.", "warp") is first
    opened = []
    monkeypatch.setattr(profiling, "_RecordFunctionFast",
                        lambda name: opened.append(name))
    model = pupflow.build_model(UPFlowConfig(), "cpu", seed=0)
    pupflow.forward(model, *pair(1))
    assert opened == []


def test_trace_writes_the_span_tree(tmp_path):
    """``profiling.trace(log_dir)`` is a profiler like any other: its
    Chrome trace holds the spans."""
    model = pupflow.build_model(UPFlowConfig(), "cpu", seed=0)
    with profiling.trace(str(tmp_path)):
        pupflow.forward(model, *pair(2))
    text = (tmp_path / profiling.TRACE_FILE).read_text()
    for name, _ in SERVING:
        assert '"%s"' % name in text, name


def test_on_path_joins_the_suffix():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("upflow.level.", 3):
            with profiling.span("upflow.copy_in"):
                torch.zeros(2).add_(1)
    events = spans(prof.events())
    assert [(e.name, owner(e)) for e in events] == [
        ("upflow.level.3", None), ("upflow.copy_in", "upflow.level.3")]
    # function-scope ranges, as the profiler opens for an operator: the
    # device operations launched inside one are linked to it
    assert not any(e.is_user_annotation for e in events)


def test_launch_opens_the_kernel_span(monkeypatch):
    """``launch`` calls the C entry point inside ``upflow.kernel.<op>``:
    the host op the profiler links the library's kernels to.  The CUDA
    queries and the entry point are stubbed."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 0, raising=False)
    calls = []

    def entry(*args):
        calls.append(args)
        torch.zeros(1)  # a host op under the span
        return 0

    wrapper = types.SimpleNamespace(launches=0)
    t = types.SimpleNamespace(device=types.SimpleNamespace(index=0))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _common.launch("corr_norm", wrapper, t, entry, 7, 8)
    assert calls == [(7, 8, 0)] and wrapper.launches == 1
    names = [e.name for e in spans(prof.events())]
    assert names == ["upflow.kernel.corr_norm"]
    zeros = [e for e in prof.events() if e.name == "aten::zeros"]
    assert [owner(e) for e in zeros] == ["upflow.kernel.corr_norm"]


def span_literals():
    """Each ``span(...)`` call's literal name in the package, with the
    suffix a call may append marked ``<suffix>``."""
    found = set()
    for path in sorted(PACKAGE.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "id", None) == "span"):
                name = node.args[0].value
                found.add(name + ("<suffix>" if len(node.args) > 1 else ""))
    return sorted(found)


def kernel_ops():
    """The ``op`` names the kernel wrappers hand to ``launch``: the
    literals assigned to ``op`` or passed as its first argument."""
    found = set()
    for m in KERNEL_MODULES:
        for node in ast.walk(ast.parse(inspect.getsource(m))):
            if (isinstance(node, ast.Assign)
                    and [getattr(t, "id", None) for t in node.targets]
                    == ["op"]):
                found.add(node.value.value)
            elif (isinstance(node, ast.Call)
                  and getattr(node.func, "id", None) == "launch"
                  and isinstance(node.args[0], ast.Constant)):
                found.add(node.args[0].value)
    return sorted(found)


def test_every_span_of_the_table_is_in_the_package():
    assert span_literals() == sorted(
        [n for n, _ in SERVING if not n.startswith("upflow.level.")]
        + list(STEP) + ["upflow.level.<suffix>", "upflow.kernel.<suffix>"]
        + ["upflow.rule.%s" % fn.__name__ for fn in functions()])


def test_every_kernel_op_is_named():
    assert kernel_ops() == ["conv3x3_seg", "corr_norm", "correlation",
                            "feature_warp", "sgu_blend", "sgu_blend_pair",
                            "sgu_final", "warp"]


@pytest.mark.parametrize("name", span_literals() + [
    "upflow.kernel." + op for op in kernel_ops()])
def test_span_names_stay_clear_of_older_metrics(name):
    """The benchmark's ``conv_device_ms`` counts ranges whose name holds
    'convolution', and ``bwd_rule_device_ms.train`` those that start with
    'bench_'."""
    assert name.startswith("upflow.")
    assert "convolution" not in name.lower()
    assert not name.startswith("bench_")


def functions():
    return sorted({obj for m in KERNEL_MODULES for obj in vars(m).values()
                   if inspect.isclass(obj)
                   and issubclass(obj, torch.autograd.Function)
                   and obj.__module__ == m.__name__},
                  key=lambda fn: fn.__name__)


@pytest.mark.parametrize("fn", functions(), ids=lambda fn: fn.__name__)
def test_backward_stays_a_staticmethod(fn):
    """The rule's span sits inside its body, so the class keeps a plain
    ``staticmethod`` that tools can find and wrap."""
    assert isinstance(vars(fn)["backward"], staticmethod)
    src = inspect.getsource(vars(fn)["backward"].__func__)
    assert 'span("upflow.rule.%s")' % fn.__name__ in src
