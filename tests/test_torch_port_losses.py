"""The port's losses and the ops they use against the JAX package's, on the
CPU: the census transform, the photometric, census and smoothness losses,
``downsample_area``, ``boundary_dilated_warp`` and ``_nearest_resize``.

Both sides get the same seeded numpy inputs (NHWC for JAX, NCHW for the
port).  Values agree within ``VALUE_BAR`` relative to the reference's
largest magnitude; gradients (``torch.autograd.grad`` against
``jax.grad`` of the same scalar, a loss or a fixed random projection of a
map) within ``GRAD_BAR``.  Measured: values within 6.2e-7 relative
(SSIM) and gradients within 5.5e-6 (the SSIM map's and the
boundary-dilated warp's; every other gradient within 1.3e-6).

Where the bar is not met the two sides were traced to the op where they
part: the SSIM loss with occlusion weighting has bit-equal loss maps and
pooled weights (``test_weighted_ssim_map``) and parts only in the final
fp32 sum of 990 weighted terms, whose order differs between XLA and
torch (1.6e-6 relative measured), so that case has ``SUM_BAR``.

``torch_math_warmed`` runs torch's CPU math functions once before any
comparison: in a process that had already run JAX computations, the
first ``torch.sqrt`` call returned values up to 3e-4 off (in about half
of the runs; every later call agreed with numpy's correctly rounded
``sqrt`` within an ulp), which made the census transform's comparison
fail at random.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upflow_pytorch_tpu.losses import census as jcensus
from upflow_pytorch_tpu.losses import photometric as jphoto
from upflow_pytorch_tpu.losses import smoothness as jsmooth
from upflow_pytorch_tpu.models import upflow as jupflow
from upflow_pytorch_tpu.ops import census as jcensus_ops
from upflow_pytorch_tpu.ops import resize as jresize
from upflow_pytorch_tpu.ops import warp as jwarp

from upflow_pytorch_tpu_torch.losses import census as pcensus
from upflow_pytorch_tpu_torch.losses import photometric as pphoto
from upflow_pytorch_tpu_torch.losses import smoothness as psmooth
from upflow_pytorch_tpu_torch.models import upflow as pupflow
from upflow_pytorch_tpu_torch.ops import census as pcensus_ops
from upflow_pytorch_tpu_torch.ops import resize as presize
from upflow_pytorch_tpu_torch.ops import warp as pwarp

VALUE_BAR = 1e-6
SUM_BAR = 3e-6
GRAD_BAR = 1e-5


@pytest.fixture(scope="module", autouse=True)
def torch_math_warmed():
    x = torch.linspace(0.5, 2.0, 4096)
    for fn in (torch.sqrt, torch.rsqrt, torch.exp, torch.log,
               torch.sigmoid, torch.tanh, lambda t: t ** 0.4):
        fn(x)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(
        0, 3, 1, 2)))


def _nhwc(x):
    return np.asarray(x.detach()).transpose(0, 2, 3, 1)


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _check(jfn, pfn, arrays, grad_args, value_bar=VALUE_BAR):
    """Holds ``pfn`` (NCHW tensors -> scalar) against ``jfn`` (NHWC arrays
    -> scalar) at ``arrays`` (NHWC numpy): the values, and the gradients
    with respect to the arrays at indices ``grad_args``."""
    jargs = [jnp.asarray(a) for a in arrays]
    want, jgrads = jax.value_and_grad(jfn, argnums=tuple(grad_args))(*jargs)
    targs = [_nchw(a).requires_grad_(i in grad_args)
             for i, a in enumerate(arrays)]
    got = pfn(*targs)
    got_value = got.detach()
    assert _rel(got_value, want) <= value_bar, (float(got_value), float(want))
    tgrads = torch.autograd.grad(got, [targs[i] for i in grad_args])
    for i, tg, jg in zip(grad_args, tgrads, jgrads):
        err = _rel(_nhwc(tg), jg)
        assert err <= GRAD_BAR, "grad %d: %.3e" % (i, err)


def _images(seed, b=2, h=13, w=17, c=3):
    rng = np.random.RandomState(seed)
    return [rng.rand(b, h, w, c).astype(np.float32) for _ in range(2)]


def _occ(seed, b=2, h=13, w=17):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, h, w, 1) > 0.3).astype(np.float32)


PHOTO_TYPES = ["abs_robust", "charbonnier", "L1", "SSIM"]


@pytest.mark.parametrize("use_occ", [False, True])
@pytest.mark.parametrize("kind", PHOTO_TYPES)
def test_photo_loss_multi_type(kind, use_occ):
    x, y = _images(1)
    occ = _occ(2)
    _check(lambda a, b, m: jphoto.photo_loss_multi_type(a, b, m, kind, 0.4,
                                                        use_occ),
           lambda a, b, m: pphoto.photo_loss_multi_type(a, b, m, kind, 0.4,
                                                        use_occ),
           [x, y, occ], (0, 1),
           SUM_BAR if (kind, use_occ) == ("SSIM", True) else VALUE_BAR)


@pytest.mark.parametrize("c1,c2", [(float("inf"), 9e-6), (1e-4, 9e-6),
                                   (1e-4, float("inf"))])
def test_weighted_ssim_map(c1, c2):
    """The loss map and the pooled weight, values and gradients (the map
    through a fixed random projection)."""
    x, y = _images(3)
    occ = _occ(4) * 0.7 + 0.1
    proj = np.random.RandomState(5).rand(2, 11, 15, 3).astype(np.float32)
    jmap, jw = jphoto.weighted_ssim(jnp.asarray(x), jnp.asarray(y),
                                    jnp.asarray(occ), c1, c2)
    pmap, pw = pphoto.weighted_ssim(_nchw(x), _nchw(y), _nchw(occ), c1, c2)
    assert _rel(_nhwc(pmap), jmap) <= VALUE_BAR
    assert _rel(_nhwc(pw), jw) <= VALUE_BAR
    _check(lambda a, b, m: jnp.sum(jphoto.weighted_ssim(a, b, m, c1, c2)[0]
                                   * proj),
           lambda a, b, m: (pphoto.weighted_ssim(a, b, m, c1, c2)[0]
                            * _nchw(proj)).sum(),
           [x, y, occ], (0, 1, 2))


def test_census_transform_and_distance():
    x, y = _images(6, c=3)
    jt1 = jcensus_ops.ternary_transform(jnp.asarray(x))
    jt2 = jcensus_ops.ternary_transform(jnp.asarray(y))
    pt1 = pcensus_ops.ternary_transform(_nchw(x))
    pt2 = pcensus_ops.ternary_transform(_nchw(y))
    assert _rel(_nhwc(pt1), jt1) <= VALUE_BAR
    jd = jcensus_ops.census_hamming_distance(jt1, jt2)
    pd = pcensus_ops.census_hamming_distance(pt1, pt2)
    assert _rel(_nhwc(pd), jd) <= VALUE_BAR
    jm = jcensus_ops.census_border_mask((2, 13, 17, 1))
    pm = pcensus_ops.census_border_mask((2, 1, 13, 17))
    np.testing.assert_array_equal(_nhwc(pm), np.asarray(jm))


@pytest.mark.parametrize("use_occ", [False, True])
@pytest.mark.parametrize("robust", [False, True])
def test_census_loss(robust, use_occ):
    x, y = _images(7)
    occ = _occ(8)
    _check(lambda a, b, m: jcensus.census_loss(a, b, m, 0.4, robust,
                                               use_occ),
           lambda a, b, m: pcensus.census_loss(a, b, m, 0.4, robust,
                                               use_occ),
           [x, y, occ], (0, 1))


@pytest.mark.parametrize("average", [True, False])
@pytest.mark.parametrize("use_occ", [False, True])
@pytest.mark.parametrize("robust", [False, True])
def test_photo_loss_function(robust, use_occ, average):
    rng = np.random.RandomState(9)
    diff = (rng.rand(2, 9, 11, 1) - 0.5).astype(np.float32)
    mask = _occ(10, h=9, w=11)
    _check(lambda d, m: jcensus.photo_loss_function(d, m, 0.4, robust,
                                                    use_occ, average),
           lambda d, m: pcensus.photo_loss_function(d, m, 0.4, robust,
                                                    use_occ, average),
           [diff, mask], (0,))


SMOOTH = {"order1": (jsmooth.edge_aware_smoothness_order1,
                     psmooth.edge_aware_smoothness_order1),
          "order2": (jsmooth.edge_aware_smoothness_order2,
                     psmooth.edge_aware_smoothness_order2)}


@pytest.mark.parametrize("name", sorted(SMOOTH))
def test_edge_aware_smoothness(name):
    img, _ = _images(11)
    flow = (np.random.RandomState(12).rand(2, 13, 17, 2) * 4 - 2
            ).astype(np.float32)
    jfn, pfn = SMOOTH[name]
    _check(jfn, pfn, [img, flow], (0, 1))


@pytest.mark.parametrize("second", [False, True])
def test_flow_smooth_delta(second):
    flow = (np.random.RandomState(13).rand(2, 13, 17, 2) * 4 - 2
            ).astype(np.float32)
    _check(lambda f: jsmooth.flow_smooth_delta(f, second),
           lambda f: psmooth.flow_smooth_delta(f, second), [flow], (0,))


@pytest.mark.parametrize("in_hw,out_hw", [((37, 53), (9, 13)),
                                          ((40, 96), (10, 24)),
                                          ((23, 31), (7, 31)),
                                          ((64, 96), (16, 24))])
def test_downsample_area(in_hw, out_hw):
    """Ragged and exact ratios, one axis kept; value and gradient."""
    rng = np.random.RandomState(sum(in_hw))
    x = rng.rand(2, *in_hw, 3).astype(np.float32)
    proj = rng.rand(2, *out_hw, 3).astype(np.float32)
    want = jresize.downsample_area(jnp.asarray(x), out_hw)
    got = presize.downsample_area(_nchw(x), out_hw)
    assert got.shape == (2, 3) + out_hw
    assert _rel(_nhwc(got), want) <= VALUE_BAR
    _check(lambda a: jnp.sum(jresize.downsample_area(a, out_hw) * proj),
           lambda a: (presize.downsample_area(a, out_hw)
                      * _nchw(proj)).sum(), [x], (0,))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_boundary_dilated_warp(seed):
    """A 12 x 16 crop at (x, y) = (4, 6) and (0, 0) of a 20 x 28 frame,
    flows up to 14 px, so samples fall past every edge; value and
    gradients with respect to the frame and the flow."""
    rng = np.random.RandomState(seed)
    img = rng.rand(2, 20, 28, 3).astype(np.float32)
    flow = ((rng.rand(2, 12, 16, 2) - 0.5) * 28).astype(np.float32)
    start = np.array([[4, 6], [0, 0]], np.float32)
    proj = rng.rand(2, 12, 16, 3).astype(np.float32)
    px = np.arange(16)[None, None] + flow[..., 0] + start[:, 0, None, None]
    py = np.arange(12)[None, :, None] + flow[..., 1] + start[:, 1, None, None]
    assert (px < 0).any() and (px > 27).any()
    assert (py < 0).any() and (py > 19).any()
    want = jwarp.boundary_dilated_warp(jnp.asarray(img), jnp.asarray(flow),
                                       jnp.asarray(start))
    got = pwarp.boundary_dilated_warp(_nchw(img), _nchw(flow),
                                      torch.from_numpy(start))
    assert _rel(_nhwc(got), want) <= VALUE_BAR
    st = torch.from_numpy(start)
    _check(lambda a, f: jnp.sum(jwarp.boundary_dilated_warp(
               a, f, jnp.asarray(start)) * proj),
           lambda a, f: (pwarp.boundary_dilated_warp(a, f, st)
                         * _nchw(proj)).sum(), [img, flow], (0, 1))


@pytest.mark.parametrize("in_hw,out_hw", [((64, 96), (4, 6)),
                                          ((37, 53), (9, 13)),
                                          ((13, 17), (40, 41))])
def test_nearest_resize(in_hw, out_hw):
    x = np.random.RandomState(3).rand(2, *in_hw, 1).astype(np.float32)
    want = jupflow._nearest_resize(jnp.asarray(x), out_hw)
    got = pupflow._nearest_resize(_nchw(x), out_hw)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))
