"""The PyTorch port's ops against the JAX package's ops, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
port runs its plain versions (CPU tensors), the JAX package its XLA paths
and, for one small shape each, its Pallas kernels in interpret mode.
Layouts: the JAX ops take NHWC, the port's ops NCHW.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from upflow_pytorch_tpu.ops.correlation import correlation_xla
from upflow_pytorch_tpu.ops import normalize as jnorm
from upflow_pytorch_tpu.ops import resize as jresize
from upflow_pytorch_tpu.ops import warp as jwarp
from upflow_pytorch_tpu.ops.pallas import corr_norm as jcn
from upflow_pytorch_tpu.ops.pallas.correlation import correlation_pallas
from upflow_pytorch_tpu.ops.pallas.feature_warp import feature_warp_prep

from upflow_pytorch_tpu_torch.ops import correlation as pcorr
from upflow_pytorch_tpu_torch.ops import normalize as pnorm
from upflow_pytorch_tpu_torch.ops import resize as presize
from upflow_pytorch_tpu_torch.ops import warp as pwarp
from upflow_pytorch_tpu_torch.ops.kernels import conv3x3_seg as pseg
from upflow_pytorch_tpu_torch.ops.kernels import corr_norm as pcn
from upflow_pytorch_tpu_torch.ops.kernels import feature_warp as pfw
from upflow_pytorch_tpu_torch.ops.kernels import sgu_blend as psb
from upflow_pytorch_tpu_torch.ops.kernels import sgu_final as psf
from upflow_pytorch_tpu_torch.ops.kernels import warp as pkw

NORM_KNOBS = [
    dict(normalize=True, center=True, moments_across_channels=c,
         moments_across_images=i)
    for c in (False, True) for i in (False, True)
] + [dict(normalize=False, center=True, moments_across_channels=False,
          moments_across_images=False)]


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.numpy().transpose(0, 2, 3, 1)


def _flow(rng, b, h, w, scale):
    """Uniform flows in [-scale/2, scale/2); scale 0.05 gives near-integer
    sample coordinates, where the >= 1.0 mask is chaotic."""
    return ((rng.rand(b, h, w, 2) - 0.5) * scale).astype(np.float32)


# (batch, height, width, channels), flow scale: 6 px, near-integer, +-40 px
WARP_CASES = [((2, 16, 24, 32), 6.0), ((2, 16, 24, 32), 0.05),
              ((1, 48, 96, 8), 80.0)]


@pytest.mark.parametrize("shape,scale", WARP_CASES)
def test_masked_warp_matches_jax_bitwise_mask(shape, scale):
    rng = np.random.RandomState(0)
    x = rng.rand(*shape).astype(np.float32)
    flow = _flow(rng, *shape[:3], scale)
    ref, ref_mask = jwarp.flow_warp_with_mask(jnp.asarray(x),
                                              jnp.asarray(flow))
    out, mask = pwarp.flow_warp_with_mask(_nchw(x), _nchw(flow))
    assert pwarp.mask_threshold() == 1.0
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    assert np.abs(_nhwc(out) - np.asarray(ref)).max() < 2e-7
    masked = pwarp.flow_warp_masked(_nchw(x), _nchw(flow))
    assert torch.equal(masked, out)
    if scale == 0.05:  # the chaotic case really has both mask values
        assert 0.0 < mask.mean().item() < 1.0


@pytest.mark.parametrize("shape,scale", [((2, 12, 20, 3), 5.0),
                                         ((2, 12, 20, 2), 0.05),
                                         ((1, 40, 72, 2), 80.0)])
def test_plain_warp_matches_jax(shape, scale):
    rng = np.random.RandomState(3)
    x = rng.rand(*shape).astype(np.float32)
    flow = _flow(rng, *shape[:3], scale)
    ref = np.asarray(jwarp.flow_warp(jnp.asarray(x), jnp.asarray(flow)))
    out = pwarp.flow_warp(_nchw(x), _nchw(flow))
    assert np.abs(_nhwc(out) - ref).max() < 2e-7


def test_warp_plain_versions_agree_with_public_ops():
    rng = np.random.RandomState(4)
    x = _nchw(rng.rand(2, 10, 14, 4).astype(np.float32))
    flow = _nchw(_flow(rng, 2, 10, 14, 7.0))
    assert torch.equal(pkw.warp_plain(x, flow), pwarp.flow_warp(x, flow))
    out, mask = pfw.feature_warp_plain(x, flow, 1.0, with_mask=True)
    ref_out, ref_mask = pwarp.flow_warp_with_mask(x, flow)
    assert torch.equal(out, ref_out) and torch.equal(mask, ref_mask)


@pytest.mark.parametrize("shape", [(2, 8, 24, 16), (1, 6, 20, 196),
                                   (1, 7, 13, 5)])
def test_correlation_plain_matches_jax(shape):
    rng = np.random.RandomState(9)
    f1 = rng.randn(*shape).astype(np.float32)
    f2 = rng.randn(*shape).astype(np.float32)
    ref = np.asarray(correlation_xla(jnp.asarray(f1), jnp.asarray(f2)))
    out = pcorr.correlation(_nchw(f1), _nchw(f2))
    assert out.shape == (shape[0], 81, shape[1], shape[2])
    np.testing.assert_allclose(_nhwc(out), ref, rtol=0, atol=1e-5)


def test_correlation_plain_matches_pallas_interpret():
    rng = np.random.RandomState(10)
    f1 = rng.randn(2, 8, 24, 16).astype(np.float32)
    f2 = rng.randn(2, 8, 24, 16).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(correlation_pallas(jnp.asarray(f1), jnp.asarray(f2)))
    out = pcorr.correlation_plain(_nchw(f1), _nchw(f2))
    np.testing.assert_allclose(_nhwc(out), ref, rtol=0, atol=1e-5)


def _smooth_flow(rng, b, h, w, xscale, yscale):
    """Upsampled coarse random flow: smooth, like a decoder's."""
    coarse = rng.rand(b, 2, 4, 6).astype(np.float32) - 0.5
    coarse[:, 0] *= xscale
    coarse[:, 1] *= yscale
    return presize.upsample2d_as(torch.from_numpy(coarse), (h, w)).numpy(
    ).transpose(0, 2, 3, 1).copy()


@pytest.mark.parametrize("norm_kw", NORM_KNOBS + [None])
def test_warp_norm_corr_matches_jax(norm_kw):
    rng = np.random.RandomState(13)
    shape = (2, 16, 40, 16)
    f1 = rng.randn(*shape).astype(np.float32)
    f2 = rng.randn(*shape).astype(np.float32)
    flow = _smooth_flow(rng, 2, 16, 40, 12.0, 3.0)
    ref = np.asarray(jcn.warp_norm_corr_xla(
        jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(flow), 4, norm_kw, 0.1))
    out = pcn.warp_norm_corr(_nchw(f1), _nchw(f2), _nchw(flow), norm_kw,
                             0.1, 1.0)
    # the moments differ in rounding: division by the std in the JAX
    # oracle, multiplication by rsqrt here
    np.testing.assert_allclose(_nhwc(out), ref, rtol=0, atol=1e-4)


def test_warp_norm_corr_matches_pallas_interpret():
    rng = np.random.RandomState(14)
    shape = (2, 32, 128, 16)
    f1 = rng.randn(*shape).astype(np.float32)
    f2 = rng.randn(*shape).astype(np.float32)
    flow = _smooth_flow(rng, 2, 32, 128, 5.0, 1.5)
    norm_items = tuple(sorted(NORM_KNOBS[0].items()))
    assert bool(feature_warp_prep(jnp.asarray(f2), jnp.asarray(flow))[5])
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jcn.warp_norm_corr(
            jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(flow), 4,
            norm_items, 0.1, 1.0, "fast"))
    out = pcn.warp_norm_corr(_nchw(f1), _nchw(f2), _nchw(flow),
                             NORM_KNOBS[0], 0.1, 1.0)
    np.testing.assert_allclose(_nhwc(out), ref, rtol=0, atol=1e-4)


def test_corr_norm_plain_is_affine_then_correlation():
    """The kernel's plain version: the affine on both maps, zeros outside
    the image after it, correlation, LeakyReLU."""
    rng = np.random.RandomState(15)
    f1 = torch.from_numpy(rng.randn(2, 6, 9, 11).astype(np.float32))
    f2 = torch.from_numpy(rng.randn(2, 6, 9, 11).astype(np.float32))
    aff = torch.from_numpy(rng.rand(2, 4, 6).astype(np.float32) + 0.5)
    out = pcn.corr_norm(f1, f2, aff, 0.1)
    f1n = (f1 - aff[:, 0, :, None, None]) * aff[:, 1, :, None, None]
    f2n = (f2 - aff[:, 2, :, None, None]) * aff[:, 3, :, None, None]
    ref = torch.nn.functional.leaky_relu(pcorr.correlation(f1n, f2n), 0.1)
    assert torch.equal(out, ref)


def _assert_close_to_scale(out: np.ndarray, ref: np.ndarray, tol: float):
    """|out - ref| <= tol * max|ref|: a bound relative to the output's
    scale, since rate-scaled flows reach 16 px, where one fp32 ulp is
    1.9e-6, and the two packages sum in different orders."""
    bound = tol * max(1.0, float(np.abs(ref).max()))
    assert np.abs(out - ref).max() <= bound, (np.abs(out - ref).max(), bound)


@pytest.mark.parametrize("in_hw,out_hw", [((6, 20), (12, 40)),
                                          ((12, 39), (24, 78)),
                                          ((5, 7), (5, 13)),
                                          ((96, 311), (375, 1242))])
def test_resize_matches_jax(in_hw, out_hw):
    rng = np.random.RandomState(21)
    x = rng.randn(2, in_hw[0], in_hw[1], 3).astype(np.float32)
    flow = rng.randn(2, in_hw[0], in_hw[1], 2).astype(np.float32)
    _assert_close_to_scale(
        _nhwc(presize.upsample2d_as(_nchw(x), out_hw)),
        np.asarray(jresize.upsample2d_as(jnp.asarray(x), out_hw)), 1e-6)
    for if_rate in (False, True):
        _assert_close_to_scale(
            _nhwc(presize.upsample2d_flow_as(_nchw(flow), out_hw, if_rate)),
            np.asarray(jresize.upsample2d_flow_as(jnp.asarray(flow), out_hw,
                                                  if_rate)), 1e-6)
    _assert_close_to_scale(
        _nhwc(presize.upsample_flow(_nchw(flow), out_hw)),
        np.asarray(jresize.upsample_flow(jnp.asarray(flow), out_hw)), 1e-6)


@pytest.mark.parametrize("norm_kw", NORM_KNOBS)
def test_normalize_features_matches_jax(norm_kw):
    rng = np.random.RandomState(22)
    a = (rng.randn(2, 9, 13, 8) * 3 + 1).astype(np.float32)
    b = (rng.randn(2, 9, 13, 8) * 0.5 - 2).astype(np.float32)
    ref = jnorm.normalize_features((jnp.asarray(a), jnp.asarray(b)), **norm_kw)
    out = pnorm.normalize_features((_nchw(a), _nchw(b)), **norm_kw)
    for o, r in zip(out, ref):
        _assert_close_to_scale(_nhwc(o), np.asarray(r), 1e-6)


def test_moments_match_normalize_features():
    """The affine that the normalised-correlation kernel applies equals
    normalize_features up to rsqrt against division."""
    rng = np.random.RandomState(23)
    a = torch.from_numpy(rng.randn(2, 8, 9, 13).astype(np.float32))
    b = torch.from_numpy(rng.randn(2, 8, 9, 13).astype(np.float32) * 2)
    for norm_kw in NORM_KNOBS:
        ac = norm_kw["moments_across_channels"]
        aff = pcn.affine_pair(*pcn.moments(a, ac), *pcn.moments(b, ac),
                              norm_kw)
        ref_a, ref_b = pnorm.normalize_features((a, b), **norm_kw)
        for f, ref, i in ((a, ref_a, 0), (b, ref_b, 2)):
            got = ((f - aff[:, i, :, None, None])
                   * aff[:, i + 1, :, None, None])
            torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("op", ["correlation", "corr_norm", "feature_warp",
                                "warp", "sgu_blend", "sgu_final",
                                "conv3x3_seg"])
def test_dispatch_refuses_tensors_off_the_cpu(op):
    """A tensor that is on neither the CPU nor a CUDA device gets no plain
    version and no kernel: the dispatch raises."""
    x = torch.empty((1, 2, 4, 5), device="meta")
    calls = {
        "correlation": lambda: pcorr.correlation(x, x),
        "corr_norm": lambda: pcn.corr_norm(
            x, x, torch.empty((1, 4, 2), device="meta"), 0.1),
        "feature_warp": lambda: pfw.feature_warp(x, x, 1.0),
        "warp": lambda: pkw.warp(x, x),
        "sgu_blend": lambda: psb.sgu_blend(x, x, x[:, :1]),
        "sgu_final": lambda: psf.sgu_final(
            x, torch.empty((1, 3, 4, 5), device="meta"), (16, 20)),
        "conv3x3_seg": lambda: pseg.conv3x3_seg(
            x, torch.empty((3, 2, 3, 3)), torch.empty(3)),
    }
    with pytest.raises(ValueError, match="no kernel for device"):
        calls[op]()


def test_plain_versions_count_no_cuda_calls_on_cpu():
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.rand(1, 3, 6, 7).astype(np.float32))
    plain = (pcorr.correlation_plain, pfw.feature_warp_plain, pkw.warp_plain,
             pcn.corr_norm_plain, psb.sgu_blend_plain, psf.sgu_final_plain,
             pseg.conv3x3_seg_plain)
    before = [f.cuda_calls for f in plain]
    flow = x[:, :2].contiguous()
    pcorr.correlation(x, x)
    pkw.warp(flow, flow)
    pfw.feature_warp(x, flow, 1.0)
    psb.sgu_blend(flow, flow, x[:, 2:].contiguous())
    psf.sgu_final(flow, x, (24, 28))
    pseg.conv3x3_seg(x.to(torch.bfloat16), torch.ones(2, 3, 3, 3),
                     torch.zeros(2))
    assert [f.cuda_calls for f in plain] == before
    assert (pcorr.correlation.launches, pfw.feature_warp.launches,
            pkw.warp.launches, pcn.corr_norm.launches,
            psb.sgu_blend.launches, psf.sgu_final.launches,
            pseg.conv3x3_seg.launches) == (0,) * 7
