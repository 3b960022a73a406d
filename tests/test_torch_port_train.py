"""The port's training step against the JAX package's, on the CPU.

``forward_with_loss`` runs the training recipe (``TRAIN_KNOBS``, the knobs
of ``tests/test_grad_parity.py``: photometric, census, smoothness, the
'upup' distillation, SGU, the boundary-dilated warp) on the checkpoint's
weights (``assets/synthetic_trained.npz``) and synthetic pairs with raw
frames and crop offsets (``data/synthetic.py::make_dataset``), with the
mask threshold 0.9999 on both sides (the reference's ``>= 1.0`` bit
depends on the last ulp of the flow).  The JAX side is one jitted
``value_and_grad`` per configuration; its gradients are carried to the
port's parameter names by ``checkpoint/convert.py::params_from_jax``.

Bars, with the values measured when they were set:

- fp32 loss terms within ``TERM_BAR`` relative (measured 5.1e-7 with the
  boundary-dilated warp, 2.7e-7 without);
- fp32 gradients: cosine over all parameters >= ``COSINE_BAR`` (measured
  1 - 2.1e-11 and 1 - 1.5e-11), and relative L2 error <= ``TENSOR_BAR``
  for every tensor whose norm is at least ``TENSOR_MIN`` of the largest
  (measured at most 3.9e-5 and 2.4e-5, the pyramid's coarsest convs);
- bf16 at (1, 128, 256), where ``conv3x3_seg`` is selected at decode
  level 4 and in the SGU estimator at the final stage: the terms within
  ``BF16_TERM_BAR`` relative (measured 6.5e-4) and the gradients' cosine
  >= ``BF16_COSINE_BAR`` (measured 1 - 6.0e-4).  Two correct bf16 passes
  round in different places (``test_torch_port_bf16_model.py``), and on
  the CPU the JAX package takes its XLA convolutions where the port takes
  the kernel's plain version.
"""

import dataclasses
from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import upflow_pytorch_tpu.ops.warp as jwarp
from upflow_pytorch_tpu.config import TrainerConfig as JaxTrainerConfig
from upflow_pytorch_tpu.config import UPFlowConfig as JaxConfig
from upflow_pytorch_tpu.models import upflow as jupflow
from upflow_pytorch_tpu.train import step as jstep

import upflow_pytorch_tpu_torch.ops.warp as pwarp
from upflow_pytorch_tpu_torch.checkpoint.convert import (
    params_from_jax, torch_key_for_flax_path)
from upflow_pytorch_tpu_torch.config import TrainerConfig, UPFlowConfig
from upflow_pytorch_tpu_torch.data.synthetic import make_dataset
from upflow_pytorch_tpu_torch.models import upflow as pupflow
from upflow_pytorch_tpu_torch.ops import conv as pconv_ops
from upflow_pytorch_tpu_torch.train import step as pstep

NPZ = str(Path(__file__).resolve().parents[1] / "assets"
          / "synthetic_trained.npz")
TRAIN_KNOBS = dict(
    if_norm_before_cost_volume=True,
    norm_moments_across_channels=False,
    norm_moments_across_images=False,
    if_sgu_upsample=True,
    photo_loss_census_weight=1.0,
    multi_scale_distillation_weight=0.01,
    multi_scale_distillation_style="upup",
    multi_scale_distillation_occ=True,
    if_use_boundary_warp=True,
    stop_occ_gradient=True,
)
RELAXED_THRESHOLD = 0.9999
TERMS = ("photo_loss", "smooth_loss", "census_loss", "msd_loss",
         "total_loss")
TERM_BAR = 1e-4
COSINE_BAR = 0.9999
TENSOR_BAR = 1e-3
TENSOR_MIN = 1e-3
BF16_TERM_BAR = 5e-3
BF16_COSINE_BAR = 0.998
# name -> (knobs, (batch, height, width), raw (height, width))
CONFIGS = {
    "fp32": (TRAIN_KNOBS, (2, 64, 96), (80, 120)),
    "fp32-plain-warp": (dict(TRAIN_KNOBS, if_use_boundary_warp=False),
                        (2, 64, 96), (80, 120)),
    "bf16": (dict(TRAIN_KNOBS, compute_dtype="bfloat16"), (1, 128, 256),
             (160, 288)),
}


@pytest.fixture(scope="module", autouse=True)
def torch_math_warmed():
    """One throwaway call of torch's CPU math functions: in a process that
    had run JAX computations, the first ``torch.sqrt`` call returned values
    up to 3e-4 off in about half of the runs (``test_torch_port_losses``)."""
    x = torch.linspace(0.5, 2.0, 4096)
    for fn in (torch.sqrt, torch.rsqrt, torch.exp, torch.log,
               torch.sigmoid, lambda t: t ** 0.4):
        fn(x)


@pytest.fixture(scope="module")
def jax_params():
    with np.load(NPZ) as z:
        return flax.traverse_util.unflatten_dict(
            {tuple(k.split("/")): z[k] for k in z.files})


def _batch(shape, raw, seed=3):
    b, h, w = shape
    data = make_dataset(b, seed=seed, raw_hw=raw, crop_hw=(h, w))
    return {k: v for k, v in data.items() if k != "gt_flow"}


def _port_pass(knobs, batch, remat=False):
    """The port's terms and its gradients by parameter name."""
    conf = UPFlowConfig().updated(dict(knobs, remat=remat))
    model = pupflow.build_model(conf, device="cpu", weights=NPZ)
    out = pupflow.forward_with_loss(model, batch)
    with pupflow.fp32_numerics():
        out["total_loss"].backward()
    terms = {k: float(out[k].detach()) for k in TERMS}
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return terms, grads, model


@pytest.fixture(scope="module")
def passes(jax_params):
    """Per configuration: the JAX terms and gradients (port names, OIHW),
    the port's terms and gradients."""
    results = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwarp, "MASK_THRESHOLD", RELAXED_THRESHOLD)
        mp.setattr(pwarp, "MASK_THRESHOLD", RELAXED_THRESHOLD)
        for name, (knobs, shape, raw) in CONFIGS.items():
            batch = _batch(shape, raw)
            jmodel = jupflow.build_model(JaxConfig().updated(knobs))

            def loss(p, b, jmodel=jmodel):
                out = jupflow.forward_with_loss(jmodel, p, b)
                return out["total_loss"], {k: out[k] for k in TERMS}

            (_, jterms), jgrads = jax.jit(jax.value_and_grad(
                loss, has_aux=True))(
                jax_params, {k: jnp.asarray(v) for k, v in batch.items()})
            flat = {k: np.array(v) for k, v in
                    flax.traverse_util.flatten_dict(jgrads, sep="/").items()}
            pterms, pgrads, model = _port_pass(knobs, batch)
            jg = params_from_jax(flat, model.state_dict().keys())
            results[name] = ({k: float(v) for k, v in jterms.items()}, jg,
                             pterms, pgrads)
    return results


def _flat(grads, names):
    return torch.cat([grads[n].double().flatten() for n in names])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_loss_terms_match_jax(passes, name):
    jterms, _, pterms, _ = passes[name]
    bar = BF16_TERM_BAR if name == "bf16" else TERM_BAR
    for k in TERMS:
        assert np.isfinite(pterms[k])
        err = abs(pterms[k] - jterms[k]) / abs(jterms[k])
        assert err <= bar, "%s: port %.7f jax %.7f (%.2e)" % (
            k, pterms[k], jterms[k], err)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_model_gradient_matches_jax(passes, name):
    _, jg, _, pg = passes[name]
    names = sorted(jg)
    assert set(names) == set(pg)
    a, b = _flat(pg, names), _flat(jg, names)
    cos = float(a @ b / (a.norm() * b.norm()))
    assert cos >= (BF16_COSINE_BAR if name == "bf16" else COSINE_BAR), cos
    if name == "bf16":
        return
    norms = {n: float(jg[n].double().norm()) for n in names}
    top = max(norms.values())
    for n in names:
        if norms[n] >= TENSOR_MIN * top:
            err = float((pg[n].double() - jg[n].double()).norm()) / norms[n]
            assert err <= TENSOR_BAR, "%s: relative L2 %.2e" % (n, err)


def test_every_parameter_gets_a_gradient(passes):
    """Every parameter that JAX's gradient reaches gets a nonzero one,
    the pyramid's included."""
    for name in CONFIGS:
        _, jg, _, pg = passes[name]
        for n, g in jg.items():
            if float(g.abs().max()) > 0:
                assert float(pg[n].abs().max()) > 0, (name, n)
    assert any(n.startswith("feature_pyramid_extractor") for n in jg)


def test_bf16_pass_takes_the_kernel_route(monkeypatch):
    """At (1, 128, 256) the bf16 pass runs ``conv3x3_seg`` (through its
    autograd Function) and its backward reaches the kernel-route convs'
    weights."""
    knobs, shape, raw = CONFIGS["bf16"]
    calls = []
    seg = pconv_ops.conv3x3_seg
    monkeypatch.setattr(pconv_ops, "conv3x3_seg",
                        lambda *a, **k: calls.append(1) or seg(*a, **k))
    _, grads, model = _port_pass(knobs, _batch(shape, raw))
    assert len(calls) == 48
    assert float(grads["flow_estimators.conv1.0.weight"].abs().max()) > 0


def test_remat_gives_the_same_gradients():
    knobs, shape, raw = CONFIGS["fp32"]
    batch = _batch(shape, raw, seed=5)
    terms, grads, _ = _port_pass(knobs, batch)
    terms_r, grads_r, _ = _port_pass(knobs, batch, remat=True)
    assert terms == terms_r
    for n in grads:
        assert torch.equal(grads[n], grads_r[n]), n


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_under_grad_gives_the_same_flows(dtype):
    """Under autograd the bf16 dense stacks concatenate instead of filling
    buffers; the flows are the same bits."""
    conf = UPFlowConfig().updated(dict(TRAIN_KNOBS, compute_dtype=dtype))
    model = pupflow.build_model(conf, device="cpu", weights=NPZ)
    rng = np.random.RandomState(2)
    im1, im2 = (torch.from_numpy(rng.rand(1, 3, 64, 96).astype(np.float32))
                for _ in range(2))
    with torch.no_grad():
        want = model(im1, im2)
    got = model(im1, im2)
    assert got[0].grad_fn is not None
    for a, b in zip(got[:2], want[:2]):
        assert torch.equal(a.detach(), b)
    for (af, ab), (bf, bb) in zip(got[2], want[2]):
        assert torch.equal(af.detach(), bf) and torch.equal(ab.detach(), bb)


def test_optimizer_matches_jax():
    """``make_optimizer`` against the JAX package's on the quadratic of
    ``tests/test_train.py``, with weight decay and a schedule that decays
    twice in the run."""
    w0 = np.array([1.5, -2.0, 0.5], np.float32)
    tgt = np.array([0.3, 0.1, -0.7], np.float32)
    kw = dict(lr=1e-2, weight_decay=1e-2, scheduler_gamma=0.5,
              batch_per_epoch=4)
    tw = torch.tensor(w0.copy(), requires_grad=True)
    opt = pstep.make_optimizer(TrainerConfig(**kw), [("w", tw)])
    for i in range(10):
        pstep.set_learning_rate(opt, i)
        opt.zero_grad()
        ((tw - torch.from_numpy(tgt)) ** 2).sum().backward()
        opt.step()
    tx = jstep.make_optimizer(JaxTrainerConfig(**kw))
    w = jnp.asarray(w0)
    state = tx.init(w)
    grad_fn = jax.grad(lambda w: jnp.sum((w - tgt) ** 2))
    for _ in range(10):
        updates, state = tx.update(grad_fn(w), state, w)
        w = optax.apply_updates(w, updates)
    np.testing.assert_allclose(tw.detach().numpy(), np.asarray(w),
                               rtol=1e-4, atol=1e-5)


def test_learning_rate_staircase():
    conf = TrainerConfig(lr=1.0, scheduler_gamma=0.5, batch_per_epoch=10)
    sched = optax.exponential_decay(init_value=1.0, transition_steps=10,
                                    decay_rate=0.5, staircase=True)
    for step in (0, 9, 10, 25):
        assert pstep.learning_rate(conf, step) == float(sched(step))


def test_freeze_set_and_frozen_step(jax_params):
    """``if_froze_pwc`` freezes the parameters of ``_pwc_frozen_mask``, and
    a train step leaves them bit-unchanged while the rest move."""
    mask = flax.traverse_util.flatten_dict(
        jstep._pwc_frozen_mask(jax_params))
    want = {torch_key_for_flax_path(k[1:-1]) + "." + (
        "weight" if k[-1] == "kernel" else "bias")
        for k, frozen in mask.items() if frozen}
    knobs, shape, raw = CONFIGS["fp32"]
    conf = UPFlowConfig().updated(dict(knobs, if_froze_pwc=True))
    model, state, opt = pstep.create_train_state(
        conf, TrainerConfig(), device="cpu", weights=NPZ)
    names = {n for n, _ in model.named_parameters()}
    got = {n for n in names if pstep.pwc_frozen(n)}
    assert got == want
    assert names - got == {n for n in names if n.startswith("sgi_model")}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, metrics = pstep.make_train_step(model, opt)(
        state, _batch(shape, raw))
    assert state.step == 1 and set(metrics) == set(TERMS)
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]) == (n in got), n


def test_create_train_state_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pstep.create_train_state(UPFlowConfig(), TrainerConfig())


def test_trainer_config_mirrors_jax():
    """The port's ``TrainerConfig`` keeps the JAX package's names and
    defaults for every field it has."""
    jdefaults = JaxTrainerConfig()
    for f in dataclasses.fields(TrainerConfig):
        assert getattr(TrainerConfig(), f.name) == getattr(jdefaults, f.name)
