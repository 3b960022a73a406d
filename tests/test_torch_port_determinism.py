"""The port's training step runs under deterministic algorithms, and
``KittiTrainDataConfig``.

``train/step.py::make_train_step`` runs the whole step (the forward and
its losses, the equivariance pass, the backward, the optimizer's step)
under ``deterministic_numerics``: torch's deterministic algorithms in
their strict form and cuDNN's deterministic algorithms, the caller's
three settings restored after the step, also after a step that raises.
Here, on the CPU: the settings seen inside the step (from a loss term,
its backward and the optimizer's step, patched for the test), the
caller's settings after it, and two runs of three steps from the same
seed bit-equal, with and without the equivariance pass.  On the card
``chip_smoke.py`` holds two runs bit for bit (11c) and a resumed Trainer
run against an uninterrupted one (7a).

``KittiTrainDataConfig`` is held against the JAX package's class and
against the defaults of ``data/kitti.py::KittiMultiviewDataset``.
"""

import inspect

import pytest
import torch

from upflow_pytorch_tpu.config import (
    KittiTrainDataConfig as JaxKittiTrainDataConfig)
from upflow_pytorch_tpu_torch.config import (
    KittiTrainDataConfig, TrainerConfig, UPFlowConfig)
from upflow_pytorch_tpu_torch.data.kitti import KittiMultiviewDataset
from upflow_pytorch_tpu_torch.data.synthetic import make_dataset
from upflow_pytorch_tpu_torch.train import step as pstep

# the training recipe of chip_smoke.py's phase 6 (the eval recipe with
# SGU, the census term and the distillation) on B=2 64x128 crops
KNOBS = dict(if_norm_before_cost_volume=True,
             norm_moments_across_channels=False,
             norm_moments_across_images=False, if_sgu_upsample=True,
             photo_loss_census_weight=1.0,
             multi_scale_distillation_weight=0.01,
             multi_scale_distillation_style="upup",
             multi_scale_distillation_occ=True, stop_occ_gradient=True)
SHAPE, RAW = (2, 64, 128), (80, 144)
STEPS = 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small ops: on one thread they take the same time alone and do
    not stall on a loaded machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def batch():
    b, h, w = SHAPE
    data = make_dataset(b, seed=5, raw_hw=RAW, crop_hw=(h, w))
    return {k: torch.from_numpy(v) for k, v in data.items()
            if k != "gt_flow"}


def settings():
    """The three settings ``deterministic_numerics`` sets and restores."""
    return (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.backends.cudnn.deterministic)


@pytest.fixture
def caller_settings():
    """Restores the process's settings after a test that changes them."""
    saved = settings()
    yield
    torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
    torch.backends.cudnn.deterministic = saved[2]


def train_state(eq_weight=0.0):
    conf = UPFlowConfig().updated(KNOBS)
    model, state, opt = pstep.create_train_state(conf, TrainerConfig(),
                                                 device="cpu", seed=0)
    return model, state, opt, pstep.make_train_step(
        model, opt, eq_loss_weight=eq_weight)


class Observed(torch.autograd.Function):
    """The identity, whose forward and backward record the settings."""

    @staticmethod
    def forward(ctx, x, seen):
        ctx.seen = seen
        seen.append(("loss term", settings()))
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        ctx.seen.append(("its backward", settings()))
        return g, None


def observing(monkeypatch, opt):
    """Patches the step's ``forward_with_loss`` so that its total loss
    goes through ``Observed``, and the optimizer's ``step``; returns the
    list the settings seen are appended to."""
    seen = []
    forward = pstep.forward_with_loss

    def patched(model, batch):
        out = forward(model, batch)
        out["total_loss"] = Observed.apply(out["total_loss"], seen)
        return out

    monkeypatch.setattr(pstep, "forward_with_loss", patched)
    opt_step = opt.step

    def step(*args, **kwargs):
        seen.append(("optimizer step", settings()))
        return opt_step(*args, **kwargs)

    monkeypatch.setattr(opt, "step", step)
    return seen


@pytest.mark.parametrize("caller", [(False, False, False),
                                    (True, True, False),
                                    (False, False, True)])
def test_step_is_strictly_deterministic_and_restores_settings(
        monkeypatch, batch, caller_settings, caller):
    """Inside the step (a loss term, its backward, the optimizer's step)
    deterministic algorithms are on, strict, and cuDNN's flag is set,
    whatever the caller set; after the step the caller's three settings
    are back."""
    model, state, opt, step_fn = train_state()
    seen = observing(monkeypatch, opt)
    torch.use_deterministic_algorithms(caller[0], warn_only=caller[1])
    torch.backends.cudnn.deterministic = caller[2]
    assert settings() == caller
    state, metrics = step_fn(state, batch)
    assert settings() == caller
    assert state.step == 1 and torch.isfinite(metrics["total_loss"])
    assert [where for where, _ in seen] == [
        "loss term", "its backward", "optimizer step"]
    assert all(s == (True, False, True) for _, s in seen), seen


@pytest.mark.parametrize("where", ["forward", "optimizer step"])
def test_settings_restored_after_a_step_that_raises(
        monkeypatch, batch, caller_settings, where):
    """A step that raises, in its forward or in the optimizer's step,
    leaves the caller's settings as they were."""
    model, state, opt, step_fn = train_state()

    def fail(*args, **kwargs):
        raise RuntimeError("raised inside the step")

    if where == "forward":
        monkeypatch.setattr(pstep, "forward_with_loss", fail)
    else:
        monkeypatch.setattr(opt, "step", fail)
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False
    with pytest.raises(RuntimeError, match="raised inside the step"):
        step_fn(state, batch)
    assert settings() == (False, False, False)


def test_manager_nests_in_fp32_numerics(caller_settings):
    """``fp32_numerics`` inside ``deterministic_numerics`` keeps cuDNN's
    deterministic flag set, as in the step's backward."""
    from upflow_pytorch_tpu_torch.ops.resize import fp32_numerics
    torch.backends.cudnn.deterministic = False
    with pstep.deterministic_numerics():
        with fp32_numerics():
            assert settings() == (True, False, True)
        assert settings() == (True, False, True)
    assert torch.backends.cudnn.deterministic is False


def run(batch, eq_weight):
    model, state, opt, step_fn = train_state(eq_weight)
    losses = []
    for _ in range(STEPS):
        state, metrics = step_fn(state, batch)
        losses.append(metrics)
    return losses, {n: p.detach().clone()
                    for n, p in model.named_parameters()}


@pytest.mark.parametrize("eq_weight", [0.0, 0.1])
def test_two_runs_bit_equal(batch, eq_weight):
    """Two runs of three steps from the same seeded weights give the same
    losses and parameters bit for bit, with and without the equivariance
    pass."""
    (la, pa), (lb, pb) = run(batch, eq_weight), run(batch, eq_weight)
    assert [set(m) for m in la] == [set(m) for m in lb]
    assert ("eq_loss" in la[0]) == (eq_weight > 0)
    for ma, mb in zip(la, lb):
        for key in ma:
            assert torch.equal(ma[key], mb[key]), key
    assert all(torch.isfinite(m["total_loss"]) for m in la)
    assert pa.keys() == pb.keys()
    for name in pa:
        assert torch.equal(pa[name], pb[name]), name


def test_kitti_train_data_config_matches_jax():
    """The fields, defaults and helpers of the JAX package's class."""
    port, jax_conf = KittiTrainDataConfig(), JaxKittiTrainDataConfig()
    assert port.get_dict() == jax_conf.get_dict()
    assert list(port.get_dict()) == list(jax_conf.get_dict())
    assert port.get_name() == jax_conf.get_name()
    change = {"rho": 4, "crop_size": (128, 416), "mv_type": "2012",
              "unknown_knob": 1}
    assert port.updated(change).get_dict() == \
        jax_conf.updated(change).get_dict()
    with pytest.raises(AttributeError):
        port.rho = 4  # frozen


def test_kitti_train_data_config_defaults_match_dataset():
    """Each knob's default is ``KittiMultiviewDataset``'s, but
    ``mv_type``: None in the config, as in the reference's, which the
    caller sets; the dataset's own default is '2015'."""
    params = inspect.signature(KittiMultiviewDataset.__init__).parameters
    conf = KittiTrainDataConfig().get_dict()
    shared = set(conf) - {"mv_type"}
    assert shared <= set(params)
    assert {k: conf[k] for k in shared} == {k: params[k].default
                                             for k in shared}
    assert conf["mv_type"] is None and params["mv_type"].default == "2015"
