"""UPFlow's bidirectional forward in plain fp32 PyTorch, NCHW.

The eval recipe of UPFlow (Luo et al., CVPR 2021; coolbeam/UPFlow_pytorch
``model/upflow.py``): a 6-level feature pyramid (16..196 channels), five
decode levels from 1/64 to 1/4 resolution with one shared dense flow
estimator (128, 128, 96, 64, 32) and context network (dilations 1, 2, 4,
8, 16, 1, 1), per-level 1x1 convs to 32 channels, self-guided upsampling
(SGU) at every level after the first and at the end, and the
forward-backward occlusion check.  The cost volume normalises both maps
by their per-image, per-channel mean and unbiased variance before an
81-tap correlation (search range 4, the channel mean) and a LeakyReLU.

The warps keep the published torch arithmetic, one IEEE operation at a
time: the ``grid_sample`` coordinate roundtrip, the ``(x0 + 1) - px``
weights and the masked warp's ``warped ones >= 1.0`` test, computed from
the in-bounds weight sum; the mask is chaotic in the flow's last bit, so
any other order of operations would flip it at random pixels.

``Numerics`` says how a run rounds (``quant``, a control's lower
precision) and which mask threshold it takes; TF32 is whatever the
caller's backend flags say, and callers that want fp32 switch it off
(``fp32``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Numerics:
    """``quant``: rounds each conv's input and weight (a control's lower
    precision), or None; ``mask_threshold``: the masked warp's test on the
    warped ones (1.0 as published; 1 - 3 ulp makes pixels with full
    in-bounds support valid whatever the flow's last bit)."""

    quant: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    mask_threshold: float = 1.0


LEAKY = 0.1
PYRAMID_LEVELS = 6
DECODE_LEVELS = 5  # 1/64 .. 1/4
DENSE = ("conv1", "conv2", "conv3", "conv4", "conv5")
CONTEXT_DILATIONS = (1, 2, 4, 8, 16, 1, 1)
SEARCH = 4
ALPHA_1, ALPHA_2 = 0.1, 0.5


@contextlib.contextmanager
def fp32(tf32: bool = False) -> Iterator[None]:
    """cuDNN's and cuBLAS's TF32 set to ``tf32`` for the block, restored
    after it."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32 = matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def conv(p: Params, name: str, x: torch.Tensor, stride: int = 1,
         dilation: int = 1, relu: bool = True,
         num: Numerics = Numerics()) -> torch.Tensor:
    w, b = p[name + ".weight"], p[name + ".bias"]
    if num.quant is not None:
        x, w = num.quant(x), num.quant(w)
    k = w.shape[-1]
    y = F.conv2d(x, w, b, stride, ((k - 1) * dilation) // 2, dilation)
    return F.leaky_relu(y, LEAKY) if relu else y


def dense(p: Params, prefix: str, x: torch.Tensor,
          num: Numerics) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense estimator: each conv's output concatenated in front of its
    input, then the linear head.  Returns (features, head)."""
    for name in DENSE:
        x = torch.cat([conv(p, prefix + name, x, num=num), x], dim=1)
    return x, conv(p, prefix + "conv_last", x, relu=False, num=num)


def pyramid(p: Params, im: torch.Tensor,
            num: Numerics) -> List[torch.Tensor]:
    """The six levels, coarsest first."""
    out, x = [], im
    for level in range(PYRAMID_LEVELS):
        name = "feature_pyramid_extractor/level%d_conv" % level
        x = conv(p, name + "0", x, stride=2, num=num)
        x = conv(p, name + "1", x, num=num)
        out.append(x)
    return out[::-1]


def upsample(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    if tuple(x.shape[2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=hw, mode="bilinear", align_corners=True)


def upsample_flow(flow: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear (align corners) resize of a flow, u scaled by the width's
    ratio and v by the height's."""
    h, w = flow.shape[2:]
    res = upsample(flow, hw)
    return torch.stack([res[:, 0] * (hw[1] / w), res[:, 1] * (hw[0] / h)],
                       dim=1)


# --- warps ------------------------------------------------------------------

def _roundtrip(p: torch.Tensor, size: int) -> torch.Tensor:
    """grid_sample's normalise and unnormalise (align corners) in fp32; the
    divisor is a tensor, since a CUDA division by a Python number
    multiplies by its reciprocal."""
    div = torch.full((), float(max(size - 1, 1)), device=p.device)
    norm = (2.0 * p) / div - 1.0
    return (norm + 1.0) / 2.0 * float(size - 1)


def coords(flow: torch.Tensor, ih: int, iw: int):
    _, _, h, w = flow.shape
    xs = torch.arange(w, dtype=torch.float32, device=flow.device)
    ys = torch.arange(h, dtype=torch.float32, device=flow.device)
    return (_roundtrip(xs[None, None, :] + flow[:, 0], iw),
            _roundtrip(ys[None, :, None] + flow[:, 1], ih))


def _taps(px: torch.Tensor, py: torch.Tensor, ih: int, iw: int):
    """The four corners' (flat index, weight, in-bounds) at coords (B, H, W),
    in the order (y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1)."""
    x0, y0 = torch.floor(px), torch.floor(py)
    wx1, wx0 = px - x0, (x0 + 1.0) - px
    wy1, wy0 = py - y0, (y0 + 1.0) - py
    out = []
    for yc, xc, wt in ((y0, x0, wy0 * wx0), (y0, x0 + 1, wy0 * wx1),
                       (y0 + 1, x0, wy1 * wx0), (y0 + 1, x0 + 1, wy1 * wx1)):
        inb = (xc >= 0) & (xc <= iw - 1) & (yc >= 0) & (yc <= ih - 1)
        idx = (yc.clamp(0, ih - 1) * iw + xc.clamp(0, iw - 1)).long()
        out.append((idx, wt, inb.float()))
    return out


def sample(x: torch.Tensor, px: torch.Tensor,
           py: torch.Tensor) -> torch.Tensor:
    """Zero-padded bilinear sample of ``x`` (B, C, Hi, Wi) at (B, H, W)."""
    b, c, ih, iw = x.shape
    _, h, w = px.shape
    flat = x.reshape(b, c, ih * iw)
    out = None
    for idx, wt, inb in _taps(px, py, ih, iw):
        v = torch.gather(flat, 2, idx.reshape(b, 1, h * w).expand(
            b, c, h * w)).reshape(b, c, h, w) * inb[:, None]
        term = v * wt[:, None]
        out = term if out is None else out + term
    return out


def warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """``torch_warp``: backward warp of ``x`` by ``flow``, zeros outside."""
    px, py = coords(flow, x.shape[2], x.shape[3])
    return sample(x, px, py)


def warp_masked(x: torch.Tensor, flow: torch.Tensor,
                threshold: float) -> torch.Tensor:
    """``WarpingLayer_no_div``: the warp times (warped ones >= threshold)."""
    ih, iw = x.shape[2:]
    px, py = coords(flow, ih, iw)
    wsum = None
    for _, wt, inb in _taps(px, py, ih, iw):
        term = wt * inb
        wsum = term if wsum is None else wsum + term
    return sample(x, px, py) * (wsum >= threshold).float()[:, None]


def sgu_blend(flow: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """The SGU blend: the flow warped by the inter-flow ``head[:, :2]``,
    mixed with itself by the sigmoid of ``head[:, 2:]``."""
    mask = torch.sigmoid(head[:, 2:3])
    return warp(flow, head[:, :2]) * (1 - mask) + flow * mask


# --- the network ------------------------------------------------------------

def normalize(f: torch.Tensor) -> torch.Tensor:
    """Per image and channel: (f - mean) / sqrt(unbiased var + 1e-16)."""
    mean = f.mean(dim=(2, 3), keepdim=True)
    var = f.var(dim=(2, 3), keepdim=True, unbiased=True)
    return (f - mean) / torch.sqrt(var + 1e-16)


def correlation(f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
    """The 81 shifted products' channel means, zeros outside ``f2``."""
    _, c, h, w = f1.shape
    d = SEARCH
    f2p = F.pad(f2, (d, d, d, d))
    return torch.stack([(f1 * f2p[:, :, dy:dy + h, dx:dx + w]).sum(dim=1)
                        for dy in range(2 * d + 1)
                        for dx in range(2 * d + 1)], dim=1) / c


def cost_volume(f1: torch.Tensor, f2: torch.Tensor,
                flow: Optional[torch.Tensor], num: Numerics) -> torch.Tensor:
    if flow is not None:
        f2 = warp_masked(f2, flow, num.mask_threshold)
    return F.leaky_relu(correlation(normalize(f1), normalize(f2)), LEAKY)


def sgu_heads(p: Params, flows, feats, num: Numerics):
    """The SGU estimator's head for each direction, on the other frame's
    1x1 features warped by that direction's flow."""
    (flow_1, flow_2), (fa, fb) = flows, feats
    return [dense(p, "sgu_dense_estimator/dense/",
                  torch.cat([f_own, warp_masked(f_other, fl,
                                                num.mask_threshold)], dim=1),
                  num)[1]
            for fl, f_own, f_other in ((flow_1, fa, fb), (flow_2, fb, fa))]


def heads(p: Params, corr, f_1x1, flow_up, num: Numerics) -> torch.Tensor:
    """The estimator's residual plus the context network's, one direction."""
    feat, res = dense(p, "flow_estimators/",
                      torch.cat([corr, f_1x1, flow_up], dim=1), num)
    x = torch.cat([feat, flow_up + res], dim=1)
    for i, d in enumerate(CONTEXT_DILATIONS):
        x = conv(p, "context_networks/conv%d" % i, x, dilation=d,
                 relu=i < len(CONTEXT_DILATIONS) - 1, num=num)
    return res + x


def network(p: Params, im1: torch.Tensor, im2: torch.Tensor,
            num: Numerics = Numerics()):
    """(flow_f, flow_b, flows): the full-resolution flows and the decode
    levels' flows, finest first.  Images NCHW fp32."""
    height, width = im1.shape[2:]
    pyr1, pyr2 = pyramid(p, im1, num), pyramid(p, im2, num)
    b = im1.shape[0]
    h0, w0 = pyr1[0].shape[2:]
    flow_f = im1.new_zeros((b, 2, h0, w0))
    flow_b = im1.new_zeros((b, 2, h0, w0))
    flows = []
    for level in range(DECODE_LEVELS):
        x1, x2 = pyr1[level], pyr2[level]
        hw = tuple(x1.shape[2:])
        name = "conv_1x1_%d" % level
        c1, c2 = conv(p, name, x1, num=num), conv(p, name, x2, num=num)
        up_f, up_b = upsample_flow(flow_f, hw), upsample_flow(flow_b, hw)
        if level > 0:
            head_f, head_b = sgu_heads(p, (up_f, up_b), (c1, c2), num)
            up_f, up_b = sgu_blend(up_f, head_f), sgu_blend(up_b, head_b)
            corr_f = cost_volume(x1, x2, up_f, num)
            corr_b = cost_volume(x2, x1, up_b, num)
        else:
            corr_f = cost_volume(x1, x2, None, num)
            corr_b = cost_volume(x2, x1, None, num)
        flow_f = up_f + heads(p, corr_f, c1, up_f, num)
        flow_b = up_b + heads(p, corr_b, c2, up_b, num)
        flows.append((flow_f, flow_b))
    q1, q2 = im1, im2
    for i, stride in enumerate((1, 2, 1, 2)):
        name = "sgu_output_conv/conv%d" % i
        q1 = conv(p, name, q1, stride=stride, num=num)
        q2 = conv(p, name, q2, stride=stride, num=num)
    hw = tuple(q1.shape[2:])
    flow_f, flow_b = upsample_flow(flow_f, hw), upsample_flow(flow_b, hw)
    head_f, head_b = sgu_heads(p, (flow_f, flow_b), (q1, q2), num)
    return (sgu_final(flow_f, head_f, (height, width)),
            sgu_final(flow_b, head_b, (height, width)), flows[::-1])


def sgu_final(flow_q: torch.Tensor, head: torch.Tensor,
              hw: Tuple[int, int]) -> torch.Tensor:
    """The final SGU stage: the quarter-resolution flow and inter-flow
    resized (rate-scaled) to ``hw``, the sigmoid of the mask logit resized,
    and the blend at full resolution."""
    flow = upsample_flow(flow_q, hw)
    inter = upsample_flow(head[:, :2], hw)
    mask = upsample(torch.sigmoid(head[:, 2:3]), hw)
    return warp(flow, inter) * (1 - mask) + flow * mask


# --- the occlusion check ----------------------------------------------------

def _length(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x ** 2).sum(dim=1, keepdim=True)


def _inside(flow: torch.Tensor) -> torch.Tensor:
    _, _, h, w = flow.shape
    xs = torch.arange(w, dtype=torch.float32, device=flow.device)
    ys = torch.arange(h, dtype=torch.float32, device=flow.device)
    px = xs[None, None, :] + flow[:, 0]
    py = ys[None, :, None] + flow[:, 1]
    return ((px <= w - 1) & (px >= 0) & (py <= h - 1) & (py >= 0))[:, None]


def occlusion(flow_f: torch.Tensor, flow_b: torch.Tensor):
    """Forward-backward check, 'obj': 1 = visible; pixels whose flow leaves
    the frame count as visible."""
    mag = _length(flow_f) + _length(flow_b)
    thresh = ALPHA_1 * mag + ALPHA_2
    occ_f = _length(flow_f + warp(flow_b, flow_f)) < thresh
    occ_b = _length(flow_b + warp(flow_f, flow_b)) < thresh
    return ((occ_f | ~_inside(flow_f)).float(),
            (occ_b | ~_inside(flow_b)).float())


def forward(p: Params, im1: torch.Tensor, im2: torch.Tensor,
            num: Numerics = Numerics()) -> Dict[str, torch.Tensor]:
    """The served outputs for NHWC fp32 images: NHWC ``flow_f_out``,
    ``flow_b_out`` (B, H, W, 2), ``occ_fw``, ``occ_bw`` (B, H, W, 1)."""
    a = im1.permute(0, 3, 1, 2).contiguous()
    b = im2.permute(0, 3, 1, 2).contiguous()
    flow_f, flow_b, _ = network(p, a, b, num)
    occ_f, occ_b = occlusion(flow_f, flow_b)
    return {k: v.permute(0, 2, 3, 1) for k, v in (
        ("flow_f_out", flow_f), ("flow_b_out", flow_b),
        ("occ_fw", occ_f), ("occ_bw", occ_b))}
