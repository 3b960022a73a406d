"""The kernel ops' gradient rules against the JAX package's, on the CPU.

Each op's autograd Function runs here as it runs on the card, but with
the plain version as its forward (CPU tensors); its backward is the
port's rule.  The reference is the JAX package's rule itself: the
custom-VJP backward ``_corr_bwd_xla``, ``jax.vjp`` of
``feature_warp_masked_fast(force="slow")``, of
``warp_norm_corr(force="slow")``, ``_fast_warp_core_bwd`` (the image
warp's XLA backward), ``jax.vjp`` of ``_sgu_blend_xla`` and
``_sgu_final_xla``, and of ``conv3x3_seg(..., interpret=True)`` at bf16.

Inputs are seeded numpy arrays at two sizes, one aligned and one ragged,
and a seeded cotangent.  Bars, relative to each reference gradient's
largest magnitude: ``FP32_BAR`` at fp32; at bf16, ``BF16_BAR`` (two bf16
ulps of the largest value: the two sides sum in fp32 in different
orders, and a sum at a rounding boundary rounds to the neighbouring
bf16).  Measured: fp32 within 7.8e-7, bf16 within 4.4e-3 (the
correlation's; ``conv3x3_seg``'s ``d_x`` 6.5e-5), except below.

One case misses ``FP32_BAR`` and was traced to where the two sides part:
``warp_norm_corr`` with moments across channels and images (the
normalisation's variance of the two per-image variances).  The per-image
variances of the two packages differ by about 1e-6 relative (their sums
run in other orders); the variance of two variances of about 0.33 that
lie within 0.008 of each other is about 2e-5, so its relative error is
3.5e-5, and the rstd and every gradient through it carry it.  Measured
2.4e-5; that case has ``ACROSS_BAR``.  The training recipe's moments
(per image and channel) agree within 7.8e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import upflow_pytorch_tpu.ops.pallas.conv as jconv
from upflow_pytorch_tpu.models.upflow import _sgu_final_xla
from upflow_pytorch_tpu.ops.pallas import correlation as jcorr
from upflow_pytorch_tpu.ops.pallas.corr_norm import warp_norm_corr as jwnc
from upflow_pytorch_tpu.ops.pallas.feature_warp import (
    feature_warp_masked_fast)
from upflow_pytorch_tpu.ops.warp import _fast_warp_core_bwd, _sgu_blend_xla

from upflow_pytorch_tpu_torch.ops.kernels import conv3x3_seg as kseg
from upflow_pytorch_tpu_torch.ops.kernels import corr_norm as kcn
from upflow_pytorch_tpu_torch.ops.kernels import correlation as kcorr
from upflow_pytorch_tpu_torch.ops.kernels import feature_warp as kfw
from upflow_pytorch_tpu_torch.ops.kernels import sgu_blend as ksb
from upflow_pytorch_tpu_torch.ops.kernels import sgu_final as ksf
from upflow_pytorch_tpu_torch.ops.kernels import warp as kwarp

FP32_BAR = 1e-5
BF16_BAR = 2 * 2.0 ** -8
ACROSS_BAR = 5e-5
BF16 = torch.bfloat16
SIZES = [(2, 16, 32), (1, 11, 19)]  # (batch, height, width)
THR = 1.0


@pytest.fixture(scope="module", autouse=True)
def torch_math_warmed():
    """One throwaway call of torch's CPU math functions: in a process that
    had run JAX computations, the first ``torch.sqrt`` call returned values
    up to 3e-4 off in about half of the runs (``test_torch_port_losses``)."""
    x = torch.linspace(0.5, 2.0, 4096)
    for fn in (torch.sqrt, torch.rsqrt, torch.exp, torch.log,
               torch.sigmoid, lambda t: t ** 0.4):
        fn(x)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(
        0, 3, 1, 2)))


def _nhwc(x):
    return np.asarray(x.detach().float()).transpose(0, 2, 3, 1)


def _rel(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32), np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _rand(rng, *shape, scale=1.0):
    return ((rng.rand(*shape) - 0.5) * 2 * scale).astype(np.float32)


def _flow(rng, b, h, w, amp):
    """Random fractional flows of up to ``amp`` px, so samples fall inside
    the map and past its edges and no coordinate is an integer."""
    return _rand(rng, b, h, w, 2, scale=amp) + np.float32(0.013)


def _port_grads(fn, arrays, g, dtypes=None):
    """Gradients of ``fn`` (NCHW tensors -> one tensor or a tuple) at NHWC
    ``arrays`` against NHWC cotangent(s) ``g``, as NHWC numpy arrays."""
    dtypes = dtypes or [torch.float32] * len(arrays)
    ts = [_nchw(a).to(dt).requires_grad_() for a, dt in zip(arrays, dtypes)]
    out = fn(*ts)
    outs = out if isinstance(out, tuple) else (out,)
    gs = g if isinstance(g, tuple) else (g,)
    assert all(o.grad_fn is not None for o in outs)
    grads = torch.autograd.grad(outs, ts, [_nchw(x).to(o.dtype)
                                           for x, o in zip(gs, outs)])
    return [_nhwc(t) for t in grads]


def _assert_close(port, ref, bar):
    for i, (p, r) in enumerate(zip(port, ref)):
        err = _rel(p, r)
        assert err <= bar, "gradient %d: %.3e > %.1e" % (i, err, bar)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("size", SIZES)
def test_correlation_rule(size, bf16):
    b, h, w = size
    rng = np.random.RandomState(h)
    f1, f2 = _rand(rng, b, h, w, 24), _rand(rng, b, h, w, 24)
    g = _rand(rng, b, h, w, 81)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    if bf16:  # the same bf16 values on both sides
        f1, f2 = (np.asarray(jnp.asarray(x, jdt).astype(jnp.float32))
                  for x in (f1, f2))
    ref = jcorr._corr_bwd_xla(4, (jnp.asarray(f1, jdt), jnp.asarray(f2, jdt)),
                              jnp.asarray(g))
    dt = BF16 if bf16 else torch.float32
    port = _port_grads(lambda a, c: kcorr.correlation(a, c, 4), [f1, f2], g,
                       [dt, dt])
    _assert_close(port, ref, BF16_BAR if bf16 else FP32_BAR)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("size", SIZES)
def test_feature_warp_rule(size, bf16):
    """The mask is the forward's, saved; the flow reaches out to 5 px so a
    share of pixels is masked."""
    b, h, w = size
    rng = np.random.RandomState(h + 1)
    x = _rand(rng, b, h, w, 32)
    flow = _flow(rng, b, h, w, 5.0)
    g = _rand(rng, b, h, w, 32)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    if bf16:
        x = np.asarray(jnp.asarray(x, jdt).astype(jnp.float32))
    _, vjp = jax.vjp(lambda a, f: feature_warp_masked_fast(a, f, THR,
                                                           "slow"),
                     jnp.asarray(x, jdt), jnp.asarray(flow))
    ref = vjp(jnp.asarray(g, jdt))
    port = _port_grads(lambda a, f: kfw.feature_warp(a, f, THR), [x, flow],
                       g, [BF16 if bf16 else torch.float32, torch.float32])
    _assert_close(port, ref, BF16_BAR if bf16 else FP32_BAR)
    mask = kfw.feature_warp(_nchw(x), _nchw(flow), THR, with_mask=True)[1]
    assert 0.05 < float(mask.mean()) < 0.95


@pytest.mark.parametrize("channels", [2, 3])
@pytest.mark.parametrize("size", SIZES)
def test_image_warp_rule(size, channels):
    b, h, w = size
    rng = np.random.RandomState(h + channels)
    x = _rand(rng, b, h, w, channels)
    flow = _flow(rng, b, h, w, 6.0)
    g = _rand(rng, b, h, w, channels)
    ref = _fast_warp_core_bwd((jnp.asarray(x), jnp.asarray(flow)),
                              jnp.asarray(g))
    port = _port_grads(kwarp.warp, [x, flow], g)
    _assert_close(port, ref, FP32_BAR)


NORMS = {"none": None,
         "recipe": (False, False),  # the training recipe's moments
         "across": (True, True)}


def _norm(name):
    if NORMS[name] is None:
        return None, None
    ac, ai = NORMS[name]
    kw = dict(normalize=True, center=True, moments_across_channels=ac,
              moments_across_images=ai)
    return kw, tuple(kw.items())


@pytest.mark.parametrize("norm", sorted(NORMS))
@pytest.mark.parametrize("size", SIZES)
def test_warp_norm_corr_rule(size, norm):
    """The composition feature-warp Function -> torch moments ->
    ``CorrNormFn`` against ``_wnc_bwd`` (the VJP of the unfused
    composition)."""
    b, h, w = size
    rng = np.random.RandomState(h + len(norm))
    f_tgt, f_src = _rand(rng, b, h, w, 16), _rand(rng, b, h, w, 16)
    flow = _flow(rng, b, h, w, 3.0)
    g = _rand(rng, b, h, w, 81)
    norm_kw, norm_items = _norm(norm)
    _, vjp = jax.vjp(lambda a, s, f: jwnc(a, s, f, 4, norm_items, 0.1, THR,
                                          "slow"),
                     jnp.asarray(f_tgt), jnp.asarray(f_src),
                     jnp.asarray(flow))
    ref = vjp(jnp.asarray(g))
    port = _port_grads(lambda a, s, f: kcn.warp_norm_corr(a, s, f, norm_kw,
                                                          0.1, THR),
                       [f_tgt, f_src, flow], g)
    _assert_close(port, ref, ACROSS_BAR if norm == "across" else FP32_BAR)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("size", SIZES)
def test_sgu_blend_pair_rule(size, bf16):
    """Both directions from the raw heads (fp32 or bf16): per direction
    the VJP of ``_sgu_blend_xla(flow, x[..., :2], sigmoid(x[..., 2:3]))``."""
    b, h, w = size
    rng = np.random.RandomState(h + 7)
    flows = [_flow(rng, b, h, w, 4.0) for _ in range(2)]
    heads = [np.concatenate([_flow(rng, b, h, w, 3.0),
                             _rand(rng, b, h, w, 1, scale=3.0)], axis=-1)
             for _ in range(2)]
    gs = tuple(_rand(rng, b, h, w, 2) for _ in range(2))
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    if bf16:
        heads = [np.asarray(jnp.asarray(x, jdt).astype(jnp.float32))
                 for x in heads]

    def jblend(fl, xo):
        xo = xo.astype(jnp.float32)
        return _sgu_blend_xla(fl, xo[..., :2], jax.nn.sigmoid(xo[..., 2:3]))

    ref = []
    for fl, xo, g in zip(flows, heads, gs):
        _, vjp = jax.vjp(jblend, jnp.asarray(fl), jnp.asarray(xo, jdt))
        ref += list(vjp(jnp.asarray(g)))
    hdt = BF16 if bf16 else torch.float32
    port = _port_grads(ksb.sgu_blend_pair,
                       [flows[0], heads[0], flows[1], heads[1]], gs,
                       [torch.float32, hdt, torch.float32, hdt])
    bars = [FP32_BAR, BF16_BAR if bf16 else FP32_BAR] * 2
    for i, (p, r, bar) in enumerate(zip(port, ref, bars)):
        assert _rel(p, r) <= bar, "gradient %d: %.3e" % (i, _rel(p, r))


@pytest.mark.parametrize("size", SIZES)
def test_sgu_blend_one_direction_rule(size):
    b, h, w = size
    rng = np.random.RandomState(h + 8)
    flow, iflow = _flow(rng, b, h, w, 4.0), _flow(rng, b, h, w, 3.0)
    mask = rng.rand(b, h, w, 1).astype(np.float32)
    g = _rand(rng, b, h, w, 2)
    _, vjp = jax.vjp(_sgu_blend_xla, jnp.asarray(flow), jnp.asarray(iflow),
                     jnp.asarray(mask))
    ref = vjp(jnp.asarray(g))
    port = _port_grads(ksb.sgu_blend, [flow, iflow, mask], g)
    _assert_close(port, ref, FP32_BAR)


@pytest.mark.parametrize("quarter,out_hw", [((2, 8, 16), (32, 64)),
                                            ((1, 7, 13), (27, 50))])
def test_sgu_final_rule(quarter, out_hw):
    b, hq, wq = quarter
    rng = np.random.RandomState(hq)
    flow_q = _flow(rng, b, hq, wq, 2.0)
    x_out = np.concatenate([_flow(rng, b, hq, wq, 1.5),
                            _rand(rng, b, hq, wq, 1, scale=3.0)], axis=-1)
    g = _rand(rng, b, *out_hw, 2)
    _, vjp = jax.vjp(lambda fq, xo: _sgu_final_xla(out_hw, (fq, xo)),
                     jnp.asarray(flow_q), jnp.asarray(x_out))
    ref = vjp(jnp.asarray(g))
    port = _port_grads(lambda fq, xo: ksf.sgu_final(fq, xo, out_hw),
                       [flow_q, x_out], g)
    _assert_close(port, ref, FP32_BAR)


# (input channels, output channels, dilation, relu, (height, width))
CONV_CASES = [(64, 32, 1, True, (16, 40)), (96, 2, 2, False, (13, 37))]


@pytest.mark.parametrize("cin,cout,d,relu,hw", CONV_CASES)
def test_conv3x3_seg_rule(cin, cout, d, relu, hw):
    """bf16: ``d_x`` in bf16 (``BF16_BAR``); the fp32 ``d_w`` and ``d_b``
    are sums of the same exact products in another order (``FP32_BAR``)."""
    rng = np.random.RandomState(cin + d)
    x = np.asarray(jnp.asarray(_rand(rng, 1, *hw, cin), jnp.bfloat16
                               ).astype(jnp.float32))
    wt = _rand(rng, 3, 3, cin, cout, scale=0.05)
    bias = _rand(rng, cout, scale=0.2)
    g = _rand(rng, 1, *hw, cout)
    _, vjp = jax.vjp(lambda a, k, c: jconv.conv3x3_seg(
        [a], [cin], k, c, d, relu, interpret=True),
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(wt), jnp.asarray(bias))
    rx, rw, rb = vjp(jnp.asarray(g, jnp.bfloat16))
    xt = _nchw(x).to(BF16).requires_grad_()
    wt_t = torch.from_numpy(wt.transpose(3, 2, 0, 1).copy()).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    out = kseg.conv3x3_seg(xt, wt_t, bt, d, relu)
    assert out.grad_fn is not None and out.dtype == BF16
    dx, dw, db = torch.autograd.grad(out, [xt, wt_t, bt],
                                     _nchw(g).to(BF16))
    assert dx.dtype == BF16 and dw.dtype == torch.float32
    assert _rel(_nhwc(dx), rx) <= BF16_BAR
    assert _rel(dw.numpy().transpose(2, 3, 1, 0), rw) <= FP32_BAR
    assert _rel(db.numpy(), rb) <= FP32_BAR


def _wrapper_calls():
    """Each wrapper with inputs that require grad, and its Function."""
    rng = np.random.RandomState(0)

    def t(*shape, dtype=torch.float32):
        return torch.from_numpy(_rand(rng, *shape)).to(dtype
                                                       ).requires_grad_()

    flow = t(1, 2, 8, 16)
    head = t(1, 3, 8, 16)
    return [
        (kcorr.CorrelationFn, lambda: kcorr.correlation(t(1, 8, 8, 16),
                                                        t(1, 8, 8, 16))),
        (kfw.FeatureWarpFn, lambda: kfw.feature_warp(t(1, 8, 8, 16), flow,
                                                     THR)),
        (kwarp.WarpFn, lambda: kwarp.warp(t(1, 2, 8, 16), flow)),
        (kcn.CorrNormFn, lambda: kcn.corr_norm(
            t(1, 8, 8, 16), t(1, 8, 8, 16), t(1, 4, 8), 0.1)),
        (ksb.SguBlendPairFn, lambda: ksb.sgu_blend_pair(flow, head, flow,
                                                        head)[0]),
        (ksb.SguBlendFn, lambda: ksb.sgu_blend(flow, flow, t(1, 1, 8, 16))),
        (ksf.SguFinalFn, lambda: ksf.sgu_final(flow, head, (32, 64))),
        (kseg.Conv3x3SegFn, lambda: kseg.conv3x3_seg(
            t(1, 64, 8, 16, dtype=BF16), t(8, 64, 3, 3), t(8))),
    ]


@pytest.mark.parametrize("case", range(8))
def test_functions_only_under_autograd(case, monkeypatch):
    """Under ``torch.no_grad()`` a wrapper calls its kernel (here its plain
    version) directly: its Function is never entered, and the result has
    no ``grad_fn``.  With grad on it is entered once."""
    fn, call = _wrapper_calls()[case]
    entered = []
    apply = fn.apply
    monkeypatch.setattr(fn, "apply",
                        lambda *a: entered.append(1) or apply(*a))
    with torch.no_grad():
        out = call()
    assert not entered and out.grad_fn is None
    out = call()
    assert entered == [1] and out.grad_fn is not None


def test_saved_head_written_in_place_raises():
    """``sgu_blend_pair`` saves the raw heads it reads in place; a write
    into a head after the forward is caught by autograd's version check
    instead of giving a wrong gradient."""
    rng = np.random.RandomState(1)
    flow = torch.from_numpy(_rand(rng, 1, 2, 8, 16)).requires_grad_()
    head = torch.from_numpy(_rand(rng, 1, 3, 8, 16)).requires_grad_()
    x = head * 1.0
    out_1, out_2 = ksb.sgu_blend_pair(flow, x, flow, x)
    with torch.no_grad():
        x.add_(1.0)
    with pytest.raises(RuntimeError, match="modified by an inplace"):
        (out_1.sum() + out_2.sum()).backward()
