"""The PyTorch port's SGU ops against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
port runs the plain versions of its SGU kernels (CPU tensors), the JAX
package its XLA formulations, the test oracle of ``test_pallas_sgu.py``
and, for inter-flows within its ±2 px tier, its Pallas blend kernel in
interpret mode.  Layouts: the JAX ops take NHWC or planar (B, H, W)
arrays, the port's NCHW.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_pallas_sgu import blend_oracle
from upflow_pytorch_tpu.models.upflow import _sgu_final_xla
from upflow_pytorch_tpu.ops.pallas.blend import sgu_blend_pallas
from upflow_pytorch_tpu.ops.warp import _sgu_blend_xla

from upflow_pytorch_tpu_torch.ops import resize as presize
from upflow_pytorch_tpu_torch.ops import warp as pwarp
from upflow_pytorch_tpu_torch.ops.kernels import sgu_blend as psb
from upflow_pytorch_tpu_torch.ops.kernels import sgu_final as psf
from upflow_pytorch_tpu_torch.ops.kernels._common import SMS


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.numpy().transpose(0, 2, 3, 1)


def _blend_inputs(seed, b, h, w, iscale):
    """Flows of ±20 px, inter-flows of ±iscale/2 px, a mask in [0, 1)."""
    rng = np.random.RandomState(seed)
    flow = ((rng.rand(b, h, w, 2) - 0.5) * 40).astype(np.float32)
    inter = ((rng.rand(b, h, w, 2) - 0.5) * iscale).astype(np.float32)
    mask = rng.rand(b, h, w, 1).astype(np.float32)
    return flow, inter, mask


# (batch, height, width) x inter-flow scale: the TPU's fused tier (±1.9
# px), its medium tier (±15 px) and beyond it (±250 px)
BLEND_CASES = [(shape, iscale) for shape in ((2, 24, 130), (1, 17, 100))
               for iscale in (3.8, 30.0, 500.0)]


@pytest.mark.parametrize("shape,iscale", BLEND_CASES)
def test_sgu_blend_plain_matches_jax(shape, iscale):
    flow, inter, mask = _blend_inputs(31, *shape, iscale)
    out = _nhwc(psb.sgu_blend(_nchw(flow), _nchw(inter), _nchw(mask)))
    ref = np.asarray(_sgu_blend_xla(jnp.asarray(flow), jnp.asarray(inter),
                                    jnp.asarray(mask)))
    assert np.abs(out - ref).max() <= 1e-6
    ou, ov = blend_oracle(*(jnp.asarray(a) for a in (
        flow[..., 0], flow[..., 1], inter[..., 0], inter[..., 1],
        mask[..., 0])))
    oracle = np.stack([np.asarray(ou), np.asarray(ov)], axis=-1)
    assert np.abs(out - oracle).max() <= 1e-6
    # the blend really mixes a warp in: the output is not the flow itself
    assert np.abs(out - flow).max() > 1.0


@pytest.mark.parametrize("shape", [(2, 24, 130), (1, 17, 100)])
def test_sgu_blend_plain_matches_pallas_interpret(shape):
    flow, inter, mask = _blend_inputs(32, *shape, 3.8)
    planes = [jnp.asarray(a) for a in (flow[..., 0], flow[..., 1],
                                       inter[..., 0], inter[..., 1],
                                       mask[..., 0])]
    gu, gv = sgu_blend_pallas(*planes, interpret=True)
    ref = np.stack([np.asarray(gu), np.asarray(gv)], axis=-1)
    out = _nhwc(psb.sgu_blend(_nchw(flow), _nchw(inter), _nchw(mask)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_sgu_blend_dispatch_equals_plain_composition():
    """``ops/warp.py::sgu_blend`` takes strided inputs and computes
    ``flow_warp(flow, inter) * (1 - m) + flow * m``."""
    flow, inter, mask = _blend_inputs(33, 2, 9, 14, 6.0)
    x_out = torch.cat([_nchw(inter), _nchw(mask)], dim=1)
    f = _nchw(flow)
    got = pwarp.sgu_blend(f, x_out[:, :2], x_out[:, 2:3])
    want = pwarp.flow_warp(f, _nchw(inter)) * (1 - _nchw(mask)) \
        + f * _nchw(mask)
    assert torch.equal(got, want)


def _raw_heads(seed, b, h, w, iscale, dtype):
    """Flows of ±20 px and two directions' raw SGU heads: inter-flow of
    ±iscale/2 px, mask logits of ±4, rounded to ``dtype``; the heads are
    also returned widened to fp32 NHWC, as the JAX op reads them."""
    rng = np.random.RandomState(seed)
    flows, heads, jax_heads = [], [], []
    for _ in range(2):
        flows.append(_nchw(((rng.rand(b, h, w, 2) - 0.5) * 40
                            ).astype(np.float32)))
        x = (rng.rand(b, h, w, 3) - 0.5).astype(np.float32)
        x[..., :2] *= iscale
        x[..., 2] *= 8.0
        head = _nchw(x).to(dtype)
        heads.append(head)
        jax_heads.append(_nhwc(head.float()))
    return flows, heads, jax_heads


PAIR_CASES = [(shape, iscale, dtype) for shape in ((2, 24, 130), (1, 17, 100))
              for iscale in (3.8, 30.0, 500.0)
              for dtype in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("shape,iscale,dtype", PAIR_CASES)
def test_sgu_blend_pair_plain_matches_jax(shape, iscale, dtype):
    """Each direction of the pair op, from the raw head (fp32 or bf16),
    equals the JAX blend of the head's inter-flow and sigmoided logit:
    the blend within 1e-6 px given the same mask, and the mask, torch's
    sigmoid of the logit, within 2 fp32 ulps of ``jax.nn.sigmoid``'s.
    (The two sigmoids differ by 1-2 ulps at about 0.4% of logits, which a
    blend of flows 20 px apart turns into up to 2e-6 px.)"""
    flows, heads, jax_heads = _raw_heads(34, *shape, iscale, dtype)
    outs = psb.sgu_blend_pair(flows[0], heads[0], flows[1], heads[1])
    assert len(outs) == 2
    for fl, out, x in zip(flows, outs, jax_heads):
        assert out.dtype == torch.float32 and out.shape == fl.shape
        mask = torch.sigmoid(torch.from_numpy(x[..., 2:3])).numpy()
        jax_mask = np.asarray(jax.nn.sigmoid(jnp.asarray(x[..., 2:3])))
        ulp = np.spacing(np.maximum(np.abs(mask), np.abs(jax_mask)))
        assert (np.abs(mask - jax_mask) <= 2 * ulp).all()
        ref = np.asarray(_sgu_blend_xla(
            jnp.asarray(_nhwc(fl)), jnp.asarray(x[..., :2]),
            jnp.asarray(mask)))
        assert np.abs(_nhwc(out) - ref).max() <= 1e-6
        assert np.abs(_nhwc(out) - _nhwc(fl)).max() > 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sgu_blend_pair_equals_single_directions(dtype):
    """The pair op's directions equal two single-direction calls with the
    mask sigmoided, bit for bit, and ``ops/warp.py::sgu_blend_pair`` is the
    same op; a head that is a channel range of a larger buffer reads the
    same."""
    flows, heads, _ = _raw_heads(35, 2, 9, 14, 30.0, dtype)
    pair = psb.sgu_blend_pair(flows[0], heads[0], flows[1], heads[1])
    for fl, x, out in zip(flows, heads, pair):
        single = psb.sgu_blend(fl, x[:, :2].float().contiguous(),
                               torch.sigmoid(x[:, 2:3].float()).contiguous())
        assert torch.equal(out, single)
    buffers = []
    for x in heads:
        buf = x.new_zeros((x.shape[0], 8) + x.shape[2:])
        buf[:, 5:] = x
        buffers.append(buf[:, 5:])
    via_ops = pwarp.sgu_blend_pair(flows[0], buffers[0], flows[1],
                                   buffers[1])
    assert all(torch.equal(a, b) for a, b in zip(via_ops, pair))


# decode levels 1-4 of B=4 384x1280 and B=1 375x1242, two directions
BLEND_LEVELS = [(4, 12, 40), (4, 24, 80), (4, 48, 160), (4, 96, 320),
                (1, 12, 39), (1, 24, 78), (1, 47, 156), (1, 94, 311)]


@pytest.mark.parametrize("b,h,w", BLEND_LEVELS)
def test_sgu_blend_launch_config(b, h, w):
    """One launch covers both directions' pixels; 2 pixels a thread on an
    even row of a level that fills more than half the card (level 4 of
    B=4 384x1280 only); the tallest block that still gives every SM a
    block, or one-row blocks where the pixels do not allow that."""
    pix, rows, blocks = psb.launch_config(2, b, h, w)
    assert pix == (2 if w % 2 == 0 and 2 * b * h * w > SMS * 1024 else 1)
    assert (pix == 2) == ((b, h, w) == (4, 96, 320))
    assert rows in psb.BLOCK_ROWS
    cols = -(-w // (psb.BLOCK_X * pix))
    assert blocks == cols * -(-h // rows) * 2 * b
    assert cols * psb.BLOCK_X * pix >= w and blocks * rows >= cols * h * 2 * b
    taller = [r for r in psb.BLOCK_ROWS if r > rows]
    assert all(cols * -(-h // r) * 2 * b < SMS for r in taller)
    assert blocks >= SMS or rows == 1
    assert psb.launch_config(2, b, h, w, vector=False)[0] == 1


def _final_inputs(seed, b, hq, wq, iscale):
    """Quarter-resolution flows of ±15 px and SGU head outputs: inter-flow
    of ±iscale/2 px, mask logits of ±3."""
    rng = np.random.RandomState(seed)
    fq = ((rng.rand(b, hq, wq, 2) - 0.5) * 30).astype(np.float32)
    xo = (rng.rand(b, hq, wq, 3) - 0.5).astype(np.float32)
    xo[..., :2] *= iscale
    xo[..., 2] *= 6.0
    return fq, xo


# (batch, Hq, Wq, H, W) x quarter-resolution inter-flow scale
FINAL_CASES = [(dims, iscale) for dims in ((1, 24, 80, 96, 320),
                                           (1, 12, 39, 47, 155))
               for iscale in (0.9, 9.0, 300.0)]


@pytest.mark.parametrize("dims,iscale", FINAL_CASES)
def test_sgu_final_plain_matches_jax(dims, iscale):
    """Mean |diff| <= 1e-5 px.  The two resizes round their two-term sums
    differently (torch's CPU matrix product fuses a multiply-add, XLA's
    does not) in about a third of the pixels, by an ulp; the warp turns an
    ulp of a sample coordinate into ulp x the local flow slope, which
    these per-pixel random flows make as steep as 30 px per px.  Hence
    the max bar of 1e-3 px, as ``test_pallas_sgu.py`` holds the TPU
    kernel to 2e-3 for the same reason."""
    b, hq, wq, h, w = dims
    fq, xo = _final_inputs(41, b, hq, wq, iscale)
    out = psf.sgu_final(_nchw(fq), _nchw(xo), (h, w))
    assert tuple(out.shape) == (b, 2, h, w)
    ref = np.asarray(_sgu_final_xla((h, w), (jnp.asarray(fq),
                                             jnp.asarray(xo))))
    diff = np.abs(_nhwc(out) - ref)
    assert diff.mean() <= 1e-5 and diff.max() <= 1e-3
    # the inter-flow moves the samples: the result is not the upsample
    up = _nhwc(presize.upsample2d_flow_as(_nchw(fq), (h, w), if_rate=True))
    assert np.abs(_nhwc(out) - up).max() > 0.1


@pytest.mark.parametrize("out_size,in_size", [(96, 24), (320, 80), (47, 12),
                                              (155, 39), (375, 94),
                                              (1242, 311), (7, 7), (5, 1)])
def test_interp_taps_lerp_equals_the_matrix(out_size, in_size):
    """The tables the final-stage kernel lerps with give the resize of
    ``ops/resize.py``: the matrix's entries, at most two a row, and the
    two-term sum, rounded as the kernel rounds it, equal to the matrix
    product."""
    idx, wt = presize.interp_taps(out_size, in_size, torch.device("cpu"))
    assert idx.shape == wt.shape == (out_size, 2)
    assert idx.dtype == torch.int32 and wt.dtype == torch.float32
    assert int(idx.min()) >= 0 and int(idx.max()) < in_size
    m = torch.from_numpy(presize._interp_matrix_np(out_size, in_size))
    dense = torch.zeros_like(m)
    rows = torch.arange(out_size)
    dense.index_put_((rows, idx[:, 0].long()), wt[:, 0], accumulate=True)
    dense.index_put_((rows, idx[:, 1].long()), wt[:, 1], accumulate=True)
    assert torch.equal(dense, m)
    x = torch.from_numpy(np.random.RandomState(out_size).randn(
        1, 2, 3, in_size).astype(np.float32) * 50)
    lerp = _mix(x[..., idx[:, 0].long()], x[..., idx[:, 1].long()],
                wt[:, 0], wt[:, 1])
    assert torch.equal(lerp, presize.resize_bilinear_align_corners(
        x, (3, out_size)))


def _mix(a, b, w0, w1):
    """The kernel's two-tap lerp ``fma(w1, b, w0 * a)``: the product
    ``w1 * b`` is exact in float64, so one float64 add and the cast round
    as the fused multiply-add does (barring a double-rounding tie)."""
    return (w1.double() * b.double() + (w0 * a).double()).float()


def _lerp_resize(q: torch.Tensor, out_hw) -> torch.Tensor:
    """The final-stage kernel's resize: the lerp of rows, then of columns,
    with ``interp_taps``."""
    ri, rw = presize.interp_taps(out_hw[0], q.shape[2], torch.device("cpu"))
    ci, cw = presize.interp_taps(out_hw[1], q.shape[3], torch.device("cpu"))
    rows = _mix(q[:, :, ri[:, 0].long()], q[:, :, ri[:, 1].long()],
                rw[:, 0, None], rw[:, 1, None])
    return _mix(rows[..., ci[:, 0].long()], rows[..., ci[:, 1].long()],
                cw[:, 0], cw[:, 1])


@pytest.mark.parametrize("dims,iscale", FINAL_CASES[:2] + FINAL_CASES[4:])
def test_sgu_final_lerp_formulation_matches_plain(dims, iscale):
    """The final-stage kernel's arithmetic, emulated in torch (lerped
    resizes, rate scales after them, the blend warp), equals its plain
    version, whose resizes are matrix products."""
    b, hq, wq, h, w = dims
    fq, xo = (_nchw(a) for a in _final_inputs(42, b, hq, wq, iscale))
    scale = torch.tensor([w / wq, h / hq], dtype=torch.float32)[:, None, None]
    flow = _lerp_resize(fq, (h, w)) * scale
    inter = _lerp_resize(xo[:, :2], (h, w)) * scale
    mask = _lerp_resize(torch.sigmoid(xo[:, 2:3]), (h, w))
    emulated = psb.sgu_blend_plain(flow, inter, mask)
    plain = psf.sgu_final_plain(fq, xo, (h, w))
    assert torch.equal(emulated, plain)


# (output, input) sizes of the resizes on the path: the final stage's x4
# at 384x1280 and 375x1242, the decode levels' x2, and edge cases
LERP_SIZES = [(96, 24), (320, 80), (384, 96), (1280, 320), (375, 94),
              (1242, 311), (47, 12), (155, 39), (7, 7), (5, 1), (1, 4)]


@pytest.mark.parametrize("out_size,in_size", LERP_SIZES)
def test_interp_taps_are_monotonic(out_size, in_size):
    """The final-stage kernel bounds the quarter-resolution rows and
    columns a range of outputs reaches by the range's first and last
    entry, which holds where both indices never decrease."""
    idx, _ = presize.interp_taps(out_size, in_size, torch.device("cpu"))
    idx = idx.numpy()
    assert (np.diff(idx, axis=0) >= 0).all()
    assert (idx[:, 1] >= idx[:, 0]).all()
