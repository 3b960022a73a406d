"""The PyTorch port's bf16 ops and conv stacks against the JAX package, on
the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
port runs its plain versions (CPU tensors), the JAX package its XLA paths
and its Pallas kernels in interpret mode.  The JAX ops take NHWC, the
port's NCHW.  Each bar states the value measured when it was set.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import upflow_pytorch_tpu.models.blocks as jblocks
import upflow_pytorch_tpu.ops.pallas.conv as pconv
from upflow_pytorch_tpu.ops import normalize as jnorm
from upflow_pytorch_tpu.ops import warp as jwarp
from upflow_pytorch_tpu.ops.correlation import correlation_xla
from upflow_pytorch_tpu.ops.pallas import corr_norm as jcn
from upflow_pytorch_tpu.ops.pallas.feature_warp import feature_warp_prep

import chip_smoke
from upflow_pytorch_tpu_torch.checkpoint.convert import params_from_jax
from upflow_pytorch_tpu_torch.checkpoint.npz_io import load_npz_flat
from upflow_pytorch_tpu_torch.config import UPFlowConfig
from upflow_pytorch_tpu_torch.models import blocks as pblocks
from upflow_pytorch_tpu_torch.models import upflow as pupflow
from upflow_pytorch_tpu_torch.ops import conv as pconv_ops
from upflow_pytorch_tpu_torch.ops import warp as pwarp
from upflow_pytorch_tpu_torch.ops.kernels import conv3x3_seg as pseg
from upflow_pytorch_tpu_torch.ops.kernels import _common as kcommon
from upflow_pytorch_tpu_torch.ops.kernels import corr_norm as pcn

NPZ = str(Path(__file__).resolve().parents[1] / "assets"
          / "synthetic_trained.npz")
BF16 = torch.bfloat16
EVAL_KNOBS = dict(if_norm_before_cost_volume=True,
                  norm_moments_across_channels=False,
                  norm_moments_across_images=False)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy().transpose(0, 2, 3, 1)


def _f32(a) -> np.ndarray:
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _bf16_values(a: np.ndarray) -> np.ndarray:
    """fp32 array of the bf16 values nearest ``a``."""
    return _f32(jnp.asarray(a, jnp.bfloat16))


def _ulps(got: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """|got - ref| in bf16 ulps of the larger magnitude of the two."""
    mag = np.maximum(np.abs(got), np.abs(ref)).astype(np.float64)
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
    return np.abs(got.astype(np.float64) - ref) / ulp


def _within_one_ulp(got: np.ndarray, ref: np.ndarray) -> bool:
    """Every value within 1 bf16 ulp of ``ref``, or, where |ref| < 1e-3 of
    max|ref| (sums that cancel, whose fp32 rounding error is not small
    against their own ulp), within 1e-5 of max|ref|."""
    scale = float(np.abs(ref).max())
    small = np.abs(ref) < 1e-3 * scale
    ok = (_ulps(got, ref) <= 1.0) | (
        small & (np.abs(got - ref) <= 1e-5 * scale))
    return bool(ok.all())


# --- conv3x3_seg -----------------------------------------------------------

def _conv_inputs(rng, segs, cout, b=2, h=16, w=40):
    """``tests/test_pallas_conv.py``'s draws: bf16 segments in [-0.5,
    0.5), weights in [-0.05, 0.05), biases in [0, 1)."""
    inputs = [_bf16_values(rng.rand(b, h, w, c) - .5) for c in segs]
    cin = sum(segs)
    wt = ((rng.rand(3, 3, cin, cout) - .5) * 0.1).astype(np.float32)
    bias = rng.rand(cout).astype(np.float32)
    return inputs, wt, bias


# the cases of tests/test_pallas_conv.py, then dilations 8 and 16 and a
# ragged 13 x 37 map
SEG_CASES = [([81, 32, 2], 128, 1, (16, 40)), ([128, 115], 96, 1, (16, 40)),
             ([64, 32], 32, 1, (16, 40)), ([115], 2, 1, (16, 40)),
             ([128], 128, 4, (16, 40)), ([96], 64, 2, (16, 40)),
             ([96], 64, 8, (16, 40)), ([128], 96, 16, (16, 40)),
             ([81, 32, 2], 32, 2, (13, 37))]


@pytest.mark.parametrize("segs,cout,d,hw", SEG_CASES)
def test_conv3x3_seg_matches_pallas_interpret(segs, cout, d, hw):
    """Every value within 1 bf16 ulp of the TPU kernel's (``_within_one_
    ulp``), at least 99% bit-equal.  Measured: 99.994-100% equal, at most
    1 ulp apart except one cancelling sum at 1.3e-7 of max|out| (2 ulp,
    3.7e-9).  The two sum the same exact products in fp32 in different
    orders, so a value rounds to the neighbouring bf16 only where the fp32
    sum lies at a rounding boundary."""
    rng = np.random.RandomState(3 + d + cout)
    inputs, wt, bias = _conv_inputs(rng, segs, cout, h=hw[0], w=hw[1])
    ref = _f32(pconv._conv3x3_seg_fwd(
        tuple(jnp.asarray(x, jnp.bfloat16) for x in inputs), tuple(segs),
        jnp.asarray(wt), jnp.asarray(bias), d, True, False, interpret=True))
    x = _nchw(np.concatenate(inputs, -1)).to(BF16)
    out = pseg.conv3x3_seg(x, torch.from_numpy(wt.transpose(3, 2, 0, 1)),
                           torch.from_numpy(bias), d, True)
    assert out.dtype == BF16 and out.shape == (2, cout) + tuple(hw)
    got = _nhwc(out)
    assert _within_one_ulp(got, ref)
    assert np.mean(got == ref) >= 0.99


def test_conv3x3_seg_writes_into_a_channel_slot():
    """Input and output as channel ranges of one buffer (the dense
    stacks' use): the same values as on standalone tensors, and the rest
    of the buffer untouched."""
    rng = np.random.RandomState(5)
    buf = torch.from_numpy(_bf16_values(rng.randn(2, 96, 9, 12))).to(BF16)
    weight = torch.from_numpy(rng.randn(16, 64, 3, 3).astype(np.float32) * .1)
    bias = torch.from_numpy(rng.randn(16).astype(np.float32))
    want = pseg.conv3x3_seg(buf[:, 32:].contiguous(), weight, bias, 2, False)
    before = buf.clone()
    pseg.conv3x3_seg(buf[:, 32:], weight, bias, 2, False, out=buf[:, 8:24])
    assert torch.equal(buf[:, 8:24], want)
    assert torch.equal(buf[:, :8], before[:, :8])
    assert torch.equal(buf[:, 24:], before[:, 24:])


@pytest.mark.parametrize("cout,nb", [(128, 128), (96, 96), (64, 64),
                                     (32, 32), (16, 16), (8, 8), (3, 8),
                                     (2, 8), (196, 128)])
def test_pack_weight_layout(cout, nb):
    """The kernel's weight layout, (Cout/NB, Cin/64, 9, NB, 64) with each
    128-byte row's 16-byte groups swizzled, unpacks to the bf16 weight
    for every output width of the model (and a 196-channel conv, two
    tiles); each value where the kernel reads it, padding zero."""
    rng = np.random.RandomState(cout)
    w = torch.from_numpy(rng.randn(cout, 70, 3, 3).astype(np.float32))
    assert pseg.block_width(cout) == nb
    p = pseg.pack_weight(w)
    n_blk = -(-cout // nb)
    assert p.shape == (n_blk, 2, 9, nb, 64) and p.dtype == BF16
    full = torch.zeros(n_blk * nb, 128, 3, 3, dtype=BF16)
    full[:cout, :70] = w.to(BF16)
    for co, ci, ky, kx in ((0, 0, 0, 0), (cout - 1, 69, 2, 1),
                           (cout // 2, 17, 1, 2)):
        n, k = co % nb, ci % 64
        group = (k // 8) ^ (n % 8)
        assert p[co // nb, ci // 64, ky * 3 + kx, n, group * 8 + k % 8] == \
            full[co, ci, ky, kx]
    rows = torch.arange(nb)[:, None]
    unswizzled = p.reshape(n_blk, 2, 9, nb, 8, 8)[
        :, :, :, rows, pseg.swizzle_index(nb)].reshape(n_blk, 2, 9, nb, 64)
    unpacked = unswizzled.permute(0, 3, 1, 4, 2).reshape(n_blk * nb, 128, 3,
                                                         3)
    assert torch.equal(unpacked, full)


def _pack_counts(block):
    """(pack_weight calls, packed weights) of one ``packed_params`` call on
    ``block``'s conv."""
    before = pseg.pack_weight.calls
    wp, bias = pseg.packed_params(block, block[0].weight, block[0].bias)
    return pseg.pack_weight.calls - before, wp, bias


def test_packed_params_cached_and_fresh():
    """A block packs once; the cached copy equals a fresh ``pack_weight``
    and the fp32 bias, and a second call packs nothing."""
    block = pblocks.ConvBlock(96, 32, generator=torch.Generator()
                              .manual_seed(0))
    with torch.no_grad():
        block[0].bias.uniform_(-1, 1)
    calls, wp, bias = _pack_counts(block)
    assert calls == 1
    assert torch.equal(wp, pseg.pack_weight(block[0].weight))
    assert bias.dtype == torch.float32 and torch.equal(bias, block[0].bias)
    calls, wp2, _ = _pack_counts(block)
    assert calls == 0 and wp2 is wp


@pytest.mark.parametrize("update", ["copy_", "load_state_dict",
                                    "params_from_jax", "bias"])
def test_packed_params_rebuilt_after_update(update):
    """The pack cache is rebuilt after every way the parameters change in
    place: ``copy_``, ``load_state_dict``, ``params_from_jax`` (the
    checkpoint import) and an update of the bias alone."""
    gen = torch.Generator().manual_seed(1)
    if update == "params_from_jax":
        model = pupflow.build_model(UPFlowConfig().updated(dict(
            EVAL_KNOBS, compute_dtype="bfloat16")), device="cpu")
        block = model.flow_estimators.conv1
    else:
        block = pblocks.ConvBlock(64, 16, generator=gen)
    _, old, old_bias = _pack_counts(block)
    old, old_bias = old.clone(), old_bias.clone()
    with torch.no_grad():
        if update == "copy_":
            block[0].weight.copy_(torch.randn(block[0].weight.shape,
                                              generator=gen))
        elif update == "load_state_dict":
            other = pblocks.ConvBlock(64, 16, generator=gen)
            block.load_state_dict(other.state_dict())
        elif update == "bias":
            block[0].bias.add_(1.0)
        else:
            model.load_state_dict(params_from_jax(
                load_npz_flat(NPZ), model.state_dict().keys()))
    calls, wp, bias = _pack_counts(block)
    assert calls == 1
    assert torch.equal(wp, pseg.pack_weight(block[0].weight))
    assert torch.equal(bias, block[0].bias.float())
    assert not (torch.equal(wp, old) and torch.equal(bias, old_bias))


@pytest.mark.parametrize("shape", chip_smoke.conv_shapes(),
                         ids=lambda s: s[0].replace(" ", "_"))
def test_staging_route_rule(shape):
    """The wrapper's staging route by TMA's 16-byte rule, for each conv of
    ``chip_smoke.conv_shapes()`` as the model lays it out (a channel range
    of its dense buffer, from a 512-byte aligned allocation): TMA at the
    aligned 384 x 1280 pyramid, a pitched copy at the 94 x 311 and 47 x 156
    rows.  A real CPU tensor of the same layout gives the same answer."""
    what, b, h, w, cin, cout, d, relu, per_forward, buf = shape
    channels, start = buf if buf is not None else (cin, 0)
    route = pseg.staging_route(w, channels * h * w, 512 + 2 * start * h * w)
    assert route == ("tma" if w % 8 == 0 else "pitched")
    assert route == ("pitched" if what.startswith("ragged") else "tma")
    full = torch.empty((1, channels, h, 8 if w % 8 == 0 else 7),
                       dtype=BF16)
    x = full[:, start:start + cin]
    assert pseg.staging_route(x.shape[3], x.stride(0), x.data_ptr()) == (
        "tma" if full.data_ptr() % 16 == 0 and w % 8 == 0 else "pitched")


def _pitched_conv_model(x, weight, d):
    """The pitched route's addressing (``csrc/conv3x3_seg.cu``, the
    Pitched tiling) in plain PyTorch: the input zero-extended to the
    pitched width and flattened per channel; tiles of 128 flat pixels; K
    step (tap row ky) a window of the flat pixels [f0 - p, f0 + 128 + p)
    shifted by (ky - 1) d Wp, zero outside the plane as TMA fills it and
    nowhere else; tap kx the window from p + (kx - 1) d; the result cropped
    to the caller's columns.  Returns (output, the box starts)."""
    b, cin, h, w = x.shape
    wp = pseg.pitched_width(w, d)
    n = h * wp
    flat = torch.nn.functional.pad(x, (0, wp - w)).reshape(b, cin, n)
    pad = 8 if d <= 8 else 16
    f0 = torch.arange(-(-n // 128)) * 128
    out = torch.zeros((b, weight.shape[0], f0.numel(), 128),
                      dtype=x.dtype)
    starts = []
    for ky in range(3):
        start = f0 - pad + (ky - 1) * d * wp
        starts += start.tolist()
        idx = start[:, None] + torch.arange(128 + 2 * pad)
        inside = (idx >= 0) & (idx < n)
        win = flat[:, :, idx.clamp(0, n - 1)] * inside
        for kx in range(3):
            off = pad + (kx - 1) * d
            out += torch.einsum("oc,bctp->botp", weight[:, :, ky, kx],
                                win[..., off:off + 128])
    out = out.reshape(b, -1, f0.numel() * 128)[..., :n]
    return out.reshape(b, -1, h, wp)[..., :w], starts


@pytest.mark.parametrize("d", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("w", [156, 311, 621])
def test_pitched_addressing(w, d):
    """The pitched route's addressing equals ``F.conv2d`` with padding d:
    a column tap past either end of a row reads the copy's zero columns
    (Wp >= W + d), a row tap above or below the image falls outside the
    flat plane, and every box starts at a multiple of 8 elements (16
    bytes), as TMA requires.  The input is a channel range of a dense
    buffer with an odd batch stride, which the wrapper stages pitched.
    Integer values in float64 make every sum exact."""
    gen = torch.Generator().manual_seed(w * 17 + d)
    bstride = 9 * 19 * w | 1  # 9 channels of 19 x w, and one element
    buf = torch.randint(-3, 4, (2 * bstride,), generator=gen).double()
    x = buf.as_strided((2, 5, 19, w), (bstride, 19 * w, w, 1), 2 * 19 * w)
    assert pseg.staging_route(w, x.stride(0), 512) == "pitched"
    weight = torch.randint(-3, 4, (3, 5, 3, 3), generator=gen).double()
    wp = pseg.pitched_width(w, d)
    assert wp % 8 == 0 and w + d <= wp < w + d + 8
    got, starts = _pitched_conv_model(x, weight, d)
    assert all(s % 8 == 0 for s in starts)
    ref = torch.nn.functional.conv2d(x, weight, padding=d, dilation=d)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("view,want", [
    (lambda t: t[:, 4:20], True),           # a channel range of a buffer
    (lambda t: t, True),
    (lambda t: t[:, :, :, 1:], False),      # a column range
    (lambda t: t.transpose(2, 3), False),
    (lambda t: t[:, 4:4], True),            # empty
    (lambda t: t[:, 4:5, :1], True),        # size-1 dims ignore strides
])
def test_inner_contiguous(view, want):
    """The wrappers' batch-strided contiguity check, read from strides
    alone, agrees with ``t[0].is_contiguous()`` on the views the dense
    stacks pass and on ones they must refuse."""
    t = view(torch.zeros(3, 24, 5, 6))
    assert kcommon.inner_contiguous(t) == want
    if t.numel():
        assert t[0].is_contiguous() == want


# --- the plain-conv route --------------------------------------------------

@pytest.mark.parametrize("k,stride,d,relu,cin,cout", [
    (3, 1, 1, True, 16, 16),      # SGUOutputConv conv0-like, small map
    (3, 2, 1, True, 32, 64),      # a stride-2 pyramid conv
    (1, 1, 1, True, 96, 32),      # a 1x1 skip conv
    (3, 1, 1, False, 32, 2),      # the context network's last conv
    (3, 1, 4, True, 128, 128),    # a dilated conv below the pixel gate
])
def test_plain_conv_route_matches_flax(k, stride, d, relu, cin, cout):
    """``nn.Conv(dtype=bfloat16)`` + ``nn.leaky_relu``: within 1.5 bf16
    ulp.  Measured: bit-equal in four cases, 3.6e-5 of values 1 ulp apart
    in the dilated one (the convs sum in different orders before the
    first rounding)."""
    rng = np.random.RandomState(k * 10 + stride + d + cin)
    x = _bf16_values(rng.randn(2, 12, 18, cin))
    wt = (rng.randn(k, k, cin, cout) * np.sqrt(2 / (k * k * cin))
          ).astype(np.float32)
    bias = (rng.randn(cout) * 0.3).astype(np.float32)
    pad = ((k - 1) * d) // 2
    conv = fnn.Conv(cout, (k, k), (stride, stride), ((pad, pad), (pad, pad)),
                    kernel_dilation=(d, d), dtype=jnp.bfloat16)
    ref = conv.apply({"params": {"kernel": jnp.asarray(wt),
                                 "bias": jnp.asarray(bias)}},
                     jnp.asarray(x, jnp.bfloat16))
    if relu:
        ref = fnn.leaky_relu(ref, negative_slope=0.1)
    ref = _f32(ref)
    out = pconv_ops.conv_plain_route(
        _nchw(x).to(BF16), torch.from_numpy(wt.transpose(3, 2, 0, 1)),
        torch.from_numpy(bias), stride, pad, d, relu)
    assert out.dtype == BF16
    got = _nhwc(out)
    assert got.shape == ref.shape
    assert _ulps(got, ref).max() <= 1.5


@pytest.mark.parametrize("cin,h,w,k,stride,kernel", [
    (64, 8, 256, 3, 1, True), (565, 32, 64, 3, 1, True),
    (63, 32, 64, 3, 1, False), (64, 7, 512, 3, 1, False),
    (64, 32, 63, 3, 1, False), (64, 32, 64, 3, 2, False),
    (64, 32, 64, 1, 1, False)])
def test_kernel_predicate(cin, h, w, k, stride, kernel):
    """The JAX ConvBlock's gate: 3x3, stride 1, bf16, >= 64 channels,
    >= 8 rows and >= 2048 pixels; never at fp32."""
    assert pconv_ops.uses_kernel(cin, h, w, k, stride, BF16) is kernel
    assert not pconv_ops.uses_kernel(cin, h, w, k, stride, torch.float32)


# --- the dense stacks --------------------------------------------------------

@pytest.fixture(scope="module")
def decoder_params():
    with np.load(NPZ) as z:
        flat = {tuple(k.split("/")): z[k] for k in z.files}
    tree = flax.traverse_util.unflatten_dict(flat)["params"]
    return tree["flow_estimators"], tree["context_networks"]


def test_estimator_context_match_jax_pallas(decoder_params, monkeypatch):
    """``FlowEstimatorDense`` -> ``ContextNetwork`` at (1, 32, 64), where
    h*w = 2048 and every dense-stack conv but the last takes the kernel,
    with the checkpoint's decoder weights, against the JAX stacks with
    the Pallas conv forced in interpret mode
    (``tests/test_blocks_stored_path.py``'s wiring).  Bars: that test's
    5e-2 for the residual and 8e-2 for residual + context (atol = rtol);
    measured max |diff| 7.8e-3 and 8.1e-3, where max |out| is 2.5 and
    2.6."""
    rng = np.random.RandomState(21)
    b, h, w = 1, 32, 64
    corr = _bf16_values(rng.randn(b, h, w, 81) * 0.3)
    feat = _bf16_values(rng.randn(b, h, w, 32) * 0.3)
    flow = (rng.randn(b, h, w, 2) * 2).astype(np.float32)

    est_p, ctx_p = decoder_params
    est = jblocks.FlowEstimatorDense(dtype=jnp.bfloat16)
    ctx = jblocks.ContextNetwork(dtype=jnp.bfloat16)
    orig = pconv.conv3x3_seg
    monkeypatch.setattr(pconv, "conv3x3_seg",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    monkeypatch.setattr(jblocks, "_pallas_conv_enabled", lambda *a, **k: True)
    feats, res = est.apply({"params": est_p},
                           [jnp.asarray(corr, jnp.bfloat16),
                            jnp.asarray(feat, jnp.bfloat16),
                            jnp.asarray(flow).astype(jnp.bfloat16)])
    res = res.astype(jnp.float32)
    fine = ctx.apply({"params": ctx_p}, feats + [
        (jnp.asarray(flow) + res).astype(jnp.bfloat16)]).astype(jnp.float32)
    ref_res, ref_out = _f32(res), _f32(res + fine)

    model = pupflow.build_model(
        UPFlowConfig().updated(dict(EVAL_KNOBS, compute_dtype="bfloat16")),
        device="cpu", weights=NPZ)
    calls = []
    orig_seg = pconv_ops.conv3x3_seg
    monkeypatch.setattr(pconv_ops, "conv3x3_seg",
                        lambda *a, **k: calls.append(1) or orig_seg(*a, **k))
    args = (_nchw(corr), _nchw(feat).to(BF16), _nchw(flow))
    with torch.no_grad():
        est_t = model.flow_estimators
        _, res_t = est_t(est_t.dense_buffer(args))
        out_t = model._heads(*args)
    assert len(calls) == 6 + 12      # estimator alone, then both stacks
    np.testing.assert_allclose(_nhwc(res_t), ref_res, atol=5e-2, rtol=5e-2)
    np.testing.assert_allclose(_nhwc(out_t), ref_out, atol=8e-2, rtol=8e-2)


# --- the bf16 cost volume ------------------------------------------------------

@pytest.mark.parametrize("shape,scale", [((2, 16, 24, 32), 6.0),
                                         ((2, 16, 24, 32), 0.05),
                                         ((1, 48, 96, 8), 80.0)])
def test_bf16_masked_warp_bit_equal(shape, scale):
    """bf16 ``flow_warp_with_mask``: the fp32 warp rounded to bf16 once,
    bit-equal to the JAX package's, mask bits included."""
    rng = np.random.RandomState(1)
    x = _bf16_values(rng.randn(*shape))
    flow = ((rng.rand(*shape[:3], 2) - 0.5) * scale).astype(np.float32)
    ref, ref_mask = jwarp.flow_warp_with_mask(jnp.asarray(x, jnp.bfloat16),
                                              jnp.asarray(flow))
    out, mask = pwarp.flow_warp_with_mask(_nchw(x).to(BF16), _nchw(flow))
    assert out.dtype == BF16 and ref.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_nhwc(out), _f32(ref))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    assert torch.equal(pwarp.flow_warp_masked(_nchw(x).to(BF16), _nchw(flow)),
                       out)


def test_bf16_warp_norm_corr_matches_fused_pallas():
    """bf16 ``warp_norm_corr`` against the TPU's fused path
    (``force="fast"``, interpret mode): the warped map rounded to bf16,
    moments and affine in fp32, no rounding of the normalised maps.  Bar
    1e-3 where max |out| is 1.4 (measured 9.9e-5; the JAX package's own
    test of this op against its oracle allows 5e-3): the two warps sum
    their taps in other orders, so now and then a warped value rounds to
    the neighbouring bf16, which moves a correlation by up to
    |f1| x 1 ulp / C."""
    rng = np.random.RandomState(13)
    shape = (1, 32, 128, 16)
    f1 = _bf16_values(rng.randn(*shape))
    f2 = _bf16_values(rng.randn(*shape))
    coarse = (rng.rand(1, 2, 4, 6).astype(np.float32) - 0.5) * [[[[4.0]],
                                                                 [[1.5]]]]
    flow = torch.nn.functional.interpolate(
        torch.from_numpy(coarse.astype(np.float32)), size=(32, 128),
        mode="bilinear", align_corners=True)
    flow_nhwc = flow.numpy().transpose(0, 2, 3, 1).copy()
    norm_items = (("normalize", True), ("center", True),
                  ("moments_across_channels", False),
                  ("moments_across_images", False))
    j1, j2 = jnp.asarray(f1, jnp.bfloat16), jnp.asarray(f2, jnp.bfloat16)
    assert bool(feature_warp_prep(j2, jnp.asarray(flow_nhwc))[5])
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jcn.warp_norm_corr(j1, j2, jnp.asarray(flow_nhwc),
                                            4, norm_items, 0.1, 1.0, "fast"))
    out = pcn.warp_norm_corr(_nchw(f1).to(BF16), _nchw(f2).to(BF16), flow,
                             dict(norm_items), 0.1, 1.0)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(out), ref, rtol=0, atol=1e-3)


def test_bf16_level0_cost_volume_matches_jax():
    """Level 0 of the bf16 decoder (``UPFlowNet._cost_volumes``):
    normalisation to bf16, fp32 correlation, LeakyReLU, rounded to bf16
    as it enters the estimator.  Within 1 bf16 ulp of the JAX composition
    (``_within_one_ulp``), under 0.5% of values differing.  Measured:
    1.0-1.5e-4 of values differ, by at most 1.5e-5 where max|out| is
    0.25; the normalised maps already differ by 1 ulp on 4e-5 of their
    values (the moments' sums run in other orders)."""
    rng = np.random.RandomState(17)
    f1 = _bf16_values(rng.randn(2, 6, 20, 196) * 2 + 0.3)
    f2 = _bf16_values(rng.randn(2, 6, 20, 196) * 2 - 0.1)
    model = pupflow.build_model(
        UPFlowConfig().updated(dict(EVAL_KNOBS, compute_dtype="bfloat16")),
        device="cpu")
    zeros = torch.zeros(2, 2, 6, 20)
    corrs = model._cost_volumes(0, zeros, zeros, _nchw(f1).to(BF16),
                                _nchw(f2).to(BF16))
    norm_kw = dict(normalize=True, center=True,
                   moments_across_channels=False, moments_across_images=False)
    for corr, (a, c) in zip(corrs, ((f1, f2), (f2, f1))):
        na, nc = jnorm.normalize_features(
            (jnp.asarray(a, jnp.bfloat16), jnp.asarray(c, jnp.bfloat16)),
            **norm_kw)
        assert na.dtype == jnp.bfloat16
        ref = _f32(fnn.leaky_relu(correlation_xla(na, nc), 0.1
                                  ).astype(jnp.bfloat16))
        got = _nhwc(corr.to(BF16))
        assert _within_one_ulp(got, ref)
        assert np.mean(got != ref) < 5e-3
