"""The port's equivariance loss (``losses/equivariance.py``) and the train
step's equivariance pass against the JAX package's, on the CPU.

The transforms are drawn by the port (a ``torch.Generator``: its draws are
not ``jax.random``'s); the JAX side gets the same ``AffineParams`` through
a monkeypatched ``random_affine``.  Bars, with the values measured when
they were set:

- ``transform_image``: the in-frame mask (``wsum >= 1.0``, chaotic in the
  last bit of the coordinates) equal bit for bit to the jitted JAX
  function's (XLA's fused kernel computes ``lin @ (x, y)`` with a fused
  multiply-add, which the port reproduces; computed with two roundings,
  some bits differ), the image within 1e-6;
- ``transform_flow`` within 1e-5 px over the in-frame pixels (the
  closed-form 2x2 inverse against JAX's LU inverse differs by ulps), on
  the smooth flows a teacher gives;
- the pass (and one train step with it, ``eq_loss_weight`` 0.1) at mask
  threshold 0.9999, as the whole-model tests: values within 1e-4
  relative (measured 1.4e-7 and 2.2e-7), gradients' cosine >= 0.9999
  (measured 1 - 1.0e-12 and 1 - 2.8e-12).  One jitted JAX function
  computes both (one compile of the model).
"""

from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import upflow_pytorch_tpu.ops.warp as jwarp
from upflow_pytorch_tpu.config import UPFlowConfig as JaxConfig
from upflow_pytorch_tpu.losses import equivariance as je
from upflow_pytorch_tpu.models import upflow as jupflow
from upflow_pytorch_tpu.train import step as jstep

import upflow_pytorch_tpu_torch.ops.warp as pwarp
from upflow_pytorch_tpu_torch.checkpoint.convert import params_from_jax
from upflow_pytorch_tpu_torch.config import TrainerConfig, UPFlowConfig
from upflow_pytorch_tpu_torch.data.synthetic import make_dataset
from upflow_pytorch_tpu_torch.losses import equivariance as pe
from upflow_pytorch_tpu_torch.models import entry
from upflow_pytorch_tpu_torch.train import step as pstep

NPZ = str(Path(__file__).resolve().parents[1] / "assets"
          / "synthetic_trained.npz")
RNG = np.random.RandomState(17)
# the JAX package's equivariance-step test's knobs (tests/test_train_eq.py)
KNOBS = dict(if_use_boundary_warp=False, if_use_cor_pytorch=True,
             if_sgu_upsample=False)
B, H, W = 2, 64, 96
EQ_WEIGHT = 0.1
RELAXED_THRESHOLD = 0.9999
TERMS = ("photo_loss", "smooth_loss", "eq_loss", "total_loss")


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1).numpy()


def jax_affine(params):
    return je.AffineParams(lin=jnp.asarray(params.lin.numpy()),
                           trans=jnp.asarray(params.trans.numpy()))


def identity(b):
    return pe.AffineParams(lin=torch.eye(2).repeat(b, 1, 1),
                           trans=torch.zeros(b, 2))


def smooth_flows(b, h, w, seed):
    """Flows as a teacher gives them: smooth (the synthetic pairs' exact
    flows, scaled up to about 15 px)."""
    data = make_dataset(b, seed=seed, raw_hw=(h + 16, w + 16),
                        crop_hw=(h, w))
    return 4.0 * data["gt_flow"]


def test_identity_transform_is_noop():
    img = torch.from_numpy(RNG.rand(2, 3, 12, 20).astype(np.float32))
    out, mask = pe.transform_image(img, identity(2))
    torch.testing.assert_close(out, img, atol=1e-6, rtol=0)
    assert float(mask.min()) == 1.0 and mask.shape == (2, 1, 12, 20)
    flow = torch.from_numpy(RNG.randn(2, 2, 12, 20).astype(np.float32))
    torch.testing.assert_close(pe.transform_flow(flow, identity(2)), flow,
                               atol=1e-5, rtol=0)


def test_hflip_transform_flips_and_negates_u():
    params = pe.AffineParams(lin=torch.tensor([[[-1.0, 0.0], [0.0, 1.0]]]),
                             trans=torch.zeros(1, 2))
    img = torch.from_numpy(RNG.rand(1, 3, 8, 16).astype(np.float32))
    out, _ = pe.transform_image(img, params)
    torch.testing.assert_close(out, img.flip(3), atol=1e-5, rtol=0)
    flow = torch.from_numpy(RNG.randn(1, 2, 8, 16).astype(np.float32))
    ref = flow.flip(3).clone()
    ref[:, 0] *= -1
    torch.testing.assert_close(pe.transform_flow(flow, params), ref,
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("seed", range(4))
def test_transforms_match_jax(seed):
    params = pe.random_affine(torch.Generator().manual_seed(seed), 3)
    img = RNG.rand(3, H, W, 3).astype(np.float32)
    jimg, jmask = jax.jit(je.transform_image)(jnp.asarray(img),
                                              jax_affine(params))
    out, mask = pe.transform_image(nchw(img), params)
    assert np.array_equal(nhwc(mask), np.asarray(jmask))
    assert 0.5 < float(mask.mean()) < 1.0
    np.testing.assert_allclose(nhwc(out), np.asarray(jimg), atol=1e-6,
                               rtol=0)
    flow = smooth_flows(3, H, W, seed)
    jflow = np.asarray(jax.jit(je.transform_flow)(jnp.asarray(flow),
                                                  jax_affine(params)))
    got = nhwc(pe.transform_flow(nchw(flow), params))
    inside = np.broadcast_to(nhwc(mask) > 0, got.shape)
    assert float(np.abs(got - jflow)[inside].max()) <= 1e-5


@pytest.mark.parametrize("loss_type", ["abs_robust", "L1"])
@pytest.mark.parametrize("with_occ", [False, True])
def test_equivariance_loss_matches_jax(loss_type, with_occ):
    s, t = (RNG.randn(2, 6, 8, 2).astype(np.float32) for _ in range(2))
    mask = (RNG.rand(2, 6, 8, 1) > 0.3).astype(np.float32)
    occ = (RNG.rand(2, 6, 8, 1) > 0.2).astype(np.float32) if with_occ \
        else None
    want = float(je.equivariance_loss(
        jnp.asarray(s), jnp.asarray(t), jnp.asarray(mask),
        None if occ is None else jnp.asarray(occ), loss_type=loss_type))
    got = float(pe.equivariance_loss(
        nchw(s), nchw(t), nchw(mask), None if occ is None else nchw(occ),
        loss_type=loss_type))
    assert abs(got - want) <= 1e-6 * abs(want)
    same = pe.equivariance_loss(nchw(s), nchw(s), nchw(mask),
                                loss_type=loss_type)
    floor = 0.01 ** 0.4 if loss_type == "abs_robust" else 0.0
    assert abs(float(same) - floor) <= 1e-6
    with pytest.raises(ValueError):
        pe.equivariance_loss(nchw(s), nchw(t), nchw(mask), loss_type="L2")


def test_random_affine_ranges_and_determinism():
    n = 4000
    p = pe.random_affine(torch.Generator().manual_seed(0), n)
    lin, t = p.lin.double(), p.trans.double()
    assert lin.shape == (n, 2, 2) and t.shape == (n, 2)
    c0, c1 = lin[:, :, 0].norm(dim=1), lin[:, :, 1].norm(dim=1)
    # A = R(th) @ diag(flip / (z*s), s/z): orthogonal columns
    assert float((lin[:, :, 0] * lin[:, :, 1]).sum(1).abs().max()) < 1e-6
    zoom = 1.0 / (c0 * c1).sqrt()
    squeeze = (c1 / c0).sqrt()
    theta = torch.rad2deg(torch.atan2(-lin[:, 0, 1], lin[:, 1, 1]))
    flip = torch.linalg.det(lin) < 0
    for v, lo, hi in ((zoom, 1.0, 1.5), (squeeze, 0.86, 1.16),
                      (theta, -10.0, 10.0), (t, -0.1, 0.1)):
        assert lo - 1e-5 <= float(v.min()) and float(v.max()) <= hi + 1e-5
        assert float(v.max() - v.min()) > 0.9 * (hi - lo)
    assert 0.45 < float(flip.double().mean()) < 0.55
    again = pe.random_affine(torch.Generator().manual_seed(0), n)
    assert torch.equal(again.lin, p.lin) and torch.equal(again.trans,
                                                         p.trans)
    other = pe.random_affine(torch.Generator().manual_seed(1), n)
    assert not torch.equal(other.lin, p.lin)
    a, b, c = (pe.random_affine(pe.step_generator(s), 4) for s in (3, 3, 4))
    assert torch.equal(a.lin, b.lin) and not torch.equal(a.lin, c.lin)


def _capture_grads():
    """An optax transformation whose state after a step is the step's
    gradient (and whose update is zero): JAX's train step then returns the
    gradient of its own ``loss_fn``."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def _cosine(a, b, names):
    x = torch.cat([a[n].double().flatten() for n in names])
    y = torch.cat([b[n].double().flatten() for n in names])
    return float(x @ y / (x.norm() * y.norm()))


@pytest.fixture(scope="module")
def runs():
    """The pass's value and gradient and one equivariance train step, both
    packages, at the step-0 draw of the port."""
    data = make_dataset(B, seed=5, raw_hw=(H + 16, W + 16), crop_hw=(H, W))
    batch = {k: data[k] for k in ("im1", "im2")}
    conf = UPFlowConfig().updated(KNOBS)
    affine = pe.random_affine(pe.step_generator(0), B)
    with np.load(NPZ) as z:
        jparams = flax.traverse_util.unflatten_dict(
            {tuple(k.split("/")): z[k] for k in z.files if "/sgu_" not in k})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwarp, "MASK_THRESHOLD", RELAXED_THRESHOLD)
        mp.setattr(pwarp, "MASK_THRESHOLD", RELAXED_THRESHOLD)
        mp.setattr(je, "random_affine", lambda rng, b: jax_affine(affine))
        # the teacher of the pass: the port's forward, handed to both
        model = entry.build_model(conf, device="cpu", weights=NPZ)
        teacher = {k: v.numpy() for k, v in
                   entry.forward(model, batch["im1"], batch["im2"]).items()
                   if k != "flows"}
        p_pass = pe.equivariance_pass(model, batch, {
            k: torch.from_numpy(v) for k, v in teacher.items()},
            pe.step_generator(0))
        p_pass.backward()
        p_pass_grads = {n: p.grad.clone() for n, p in
                        model.named_parameters()}

        model, state, opt = pstep.create_train_state(
            conf, TrainerConfig(), device="cpu", weights=NPZ)
        _, p_metrics = pstep.make_train_step(
            model, opt, eq_loss_weight=EQ_WEIGHT)(state, batch)
        p_step_grads = {n: p.grad.clone() for n, p in
                        model.named_parameters()}

        jmodel = jupflow.build_model(JaxConfig().updated(KNOBS))
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        tx = _capture_grads()
        jstate = jstep.TrainState(jparams, tx.init(jparams),
                                  jnp.zeros((), jnp.int32))
        train_step = jstep.make_train_step(jmodel, tx,
                                           eq_loss_weight=EQ_WEIGHT)

        def both(params, state):
            pass_vg = jax.value_and_grad(lambda q: je.equivariance_pass(
                jmodel, q, jbatch, teacher, jax.random.PRNGKey(0)))(params)
            return pass_vg, train_step(state, jbatch)

        (j_pass, j_pass_grads), (jstate, j_metrics) = jax.jit(both)(
            jparams, jstate)

    def port_names(grads):
        flat = {k: np.array(v) for k, v in
                flax.traverse_util.flatten_dict(grads, sep="/").items()}
        return params_from_jax(flat, model.state_dict().keys())

    return dict(
        p_pass=float(p_pass.detach()), j_pass=float(j_pass),
        p_pass_grads=p_pass_grads, j_pass_grads=port_names(j_pass_grads),
        p_metrics={k: float(v) for k, v in p_metrics.items()},
        j_metrics={k: float(v) for k, v in j_metrics.items()},
        p_step_grads=p_step_grads, j_step_grads=port_names(jstate.opt_state))


def test_pass_value_and_gradient_match_jax(runs):
    assert runs["p_pass"] > 0.01 ** 0.4
    assert abs(runs["p_pass"] - runs["j_pass"]) <= 1e-4 * runs["j_pass"]
    names = sorted(runs["j_pass_grads"])
    assert set(names) == set(runs["p_pass_grads"])
    cos = _cosine(runs["p_pass_grads"], runs["j_pass_grads"], names)
    assert cos >= 0.9999


def test_eq_train_step_matches_jax_loss_fn(runs):
    """One step with ``eq_loss_weight`` 0.1: its metrics hold JAX's
    ``loss_fn`` terms (``eq_loss`` and ``total_loss`` included), and the
    step's gradient JAX's, at the same transforms."""
    pm, jm = runs["p_metrics"], runs["j_metrics"]
    assert set(pm) == set(jm) == set(TERMS)
    for k in TERMS:
        assert np.isfinite(pm[k])
        assert abs(pm[k] - jm[k]) <= 1e-4 * abs(jm[k]), (k, pm[k], jm[k])
    assert pm["eq_loss"] > 0
    names = sorted(runs["j_step_grads"])
    cos = _cosine(runs["p_step_grads"], runs["j_step_grads"], names)
    assert cos >= 0.9999
