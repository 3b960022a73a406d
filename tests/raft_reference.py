"""RAFT's forward in plain fp32 PyTorch: the reference the port's RAFT
(``upflow_pytorch_tpu_torch/models/raft.py``) is held to.

princeton-vl/RAFT (Teed & Deng, ECCV 2020) ``core/raft.py``,
``extractor.py``, ``update.py`` and ``corr.py``, the full model, written
as functions of a flat parameter dict keyed by RAFT's own module names (a
state dict), NCHW.  It imports neither JAX nor the port; the port's fp32
state dict is its weights.  Callers switch TF32 off (``fp32``).

Departures from ``core/*.py``, none of which changes a value: one
direction a call (``raft(p, im1, im2)``), as published; the images
padded here (``InputPadder``) and the flow cropped back; the flow
upsampled once, after the last iteration, where RAFT upsamples every
iteration and test mode returns the last; no autocast (fp32 throughout).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Sequence

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

HIDDEN = 128
RADIUS = 4
LEVELS = 4


@contextlib.contextmanager
def fp32() -> Iterator[None]:
    """cuDNN's and cuBLAS's TF32 off for the block, restored after it."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def conv(p: Params, name: str, x: torch.Tensor, stride: int = 1,
         padding=0) -> torch.Tensor:
    return F.conv2d(x, p[name + ".weight"], p[name + ".bias"], stride,
                    padding)


def norm(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    """``nn.InstanceNorm2d`` (no parameters) or eval ``nn.BatchNorm2d``."""
    if name + ".running_mean" not in p:
        return F.instance_norm(x, eps=1e-5)
    return F.batch_norm(x, p[name + ".running_mean"], p[name + ".running_var"],
                        p[name + ".weight"], p[name + ".bias"], False, 0.0,
                        1e-5)


def residual_block(p: Params, name: str, x: torch.Tensor,
                   stride: int) -> torch.Tensor:
    y = F.relu(norm(p, name + ".norm1",
                    conv(p, name + ".conv1", x, stride, 1)))
    y = F.relu(norm(p, name + ".norm2", conv(p, name + ".conv2", y, 1, 1)))
    if stride != 1:
        x = norm(p, name + ".norm3",
                 conv(p, name + ".downsample.0", x, stride))
    return F.relu(x + y)


def encoder(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    """``BasicEncoder``: 1/8 resolution."""
    x = F.relu(norm(p, name + ".norm1", conv(p, name + ".conv1", x, 2, 3)))
    for layer, stride in ((1, 1), (2, 2), (3, 2)):
        x = residual_block(p, "%s.layer%d.0" % (name, layer), x, stride)
        x = residual_block(p, "%s.layer%d.1" % (name, layer), x, 1)
    return conv(p, name + ".conv2", x)


def bilinear_sampler(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    h, w = img.shape[-2:]
    xgrid, ygrid = coords.split([1, 1], dim=-1)
    xgrid = 2 * xgrid / (w - 1) - 1
    ygrid = 2 * ygrid / (h - 1) - 1
    grid = torch.cat([xgrid, ygrid], dim=-1)
    return F.grid_sample(img, grid, align_corners=True)


def corr_pyramid(fmap1: torch.Tensor,
                 fmap2: torch.Tensor) -> List[torch.Tensor]:
    """``CorrBlock.__init__``: the all-pairs volume and its pooled levels."""
    batch, dim, ht, wd = fmap1.shape
    corr = torch.matmul(fmap1.view(batch, dim, ht * wd).transpose(1, 2),
                        fmap2.view(batch, dim, ht * wd))
    corr = corr / torch.sqrt(torch.tensor(dim).float())
    corr = corr.reshape(batch * ht * wd, 1, ht, wd)
    out = [corr]
    for _ in range(LEVELS - 1):
        corr = F.avg_pool2d(corr, 2, stride=2)
        out.append(corr)
    return out


def corr_lookup(pyramid: Sequence[torch.Tensor],
                coords: torch.Tensor) -> torch.Tensor:
    """``CorrBlock.__call__``."""
    r = RADIUS
    coords = coords.permute(0, 2, 3, 1)
    batch, h1, w1, _ = coords.shape
    out = []
    for i, corr in enumerate(pyramid):
        dx = torch.linspace(-r, r, 2 * r + 1, device=coords.device)
        dy = torch.linspace(-r, r, 2 * r + 1, device=coords.device)
        delta = torch.stack(torch.meshgrid(dy, dx, indexing="ij"), dim=-1)
        centroid = coords.reshape(batch * h1 * w1, 1, 1, 2) / 2 ** i
        sampled = bilinear_sampler(corr, centroid + delta.view(
            1, 2 * r + 1, 2 * r + 1, 2))
        out.append(sampled.view(batch, h1, w1, -1))
    return torch.cat(out, dim=-1).permute(0, 3, 1, 2).contiguous().float()


def gru(p: Params, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``SepConvGRU``: a (1x5) pass, then a (5x1) pass."""
    for k, pad in (("1", (0, 2)), ("2", (2, 0))):
        name = "update_block.gru.conv%s" + k
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(conv(p, name % "z", hx, 1, pad))
        r = torch.sigmoid(conv(p, name % "r", hx, 1, pad))
        q = torch.tanh(conv(p, name % "q", torch.cat([r * h, x], dim=1), 1,
                            pad))
        h = (1 - z) * h + z * q
    return h


def update(p: Params, net: torch.Tensor, inp: torch.Tensor,
           corr: torch.Tensor, flow: torch.Tensor):
    """``BasicUpdateBlock``: (net, mask, delta_flow)."""
    e = "update_block.encoder."
    cor = F.relu(conv(p, e + "convc1", corr))
    cor = F.relu(conv(p, e + "convc2", cor, 1, 1))
    flo = F.relu(conv(p, e + "convf1", flow, 1, 3))
    flo = F.relu(conv(p, e + "convf2", flo, 1, 1))
    out = F.relu(conv(p, e + "conv", torch.cat([cor, flo], dim=1), 1, 1))
    motion = torch.cat([out, flow], dim=1)
    net = gru(p, net, torch.cat([inp, motion], dim=1))
    delta = conv(p, "update_block.flow_head.conv2", F.relu(
        conv(p, "update_block.flow_head.conv1", net, 1, 1)), 1, 1)
    mask = 0.25 * conv(p, "update_block.mask.2", F.relu(
        conv(p, "update_block.mask.0", net, 1, 1)))
    return net, mask, delta


def coords_grid(batch: int, ht: int, wd: int, device) -> torch.Tensor:
    coords = torch.meshgrid(torch.arange(ht, device=device),
                            torch.arange(wd, device=device), indexing="ij")
    coords = torch.stack(coords[::-1], dim=0).float()
    return coords[None].repeat(batch, 1, 1, 1)


def upsample_flow(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    n, _, h, w = flow.shape
    mask = torch.softmax(mask.view(n, 1, 9, 8, 8, h, w), dim=2)
    up = F.unfold(8 * flow, [3, 3], padding=1).view(n, 2, 9, 1, 1, h, w)
    up = torch.sum(mask * up, dim=2).permute(0, 1, 4, 2, 5, 3)
    return up.reshape(n, 2, 8 * h, 8 * w)


def pad_amounts(h: int, w: int) -> List[int]:
    """``InputPadder(mode='kitti')``'s [left, right, top, bottom]."""
    pad_ht = (((h // 8) + 1) * 8 - h) % 8
    pad_wd = (((w // 8) + 1) * 8 - w) % 8
    return [pad_wd // 2, pad_wd - pad_wd // 2, 0, pad_ht]


def raft(p: Params, image1: torch.Tensor, image2: torch.Tensor,
         iters: int = 24):
    """RAFT(image1, image2) in test mode on NCHW images in [0, 255]:
    (the flow at 1/8 of the padded frame, the upsampled flow cropped to
    the frame)."""
    ht, wd = image1.shape[-2:]
    pad = pad_amounts(ht, wd)
    image1 = F.pad(2 * (image1 / 255.0) - 1.0, pad, mode="replicate")
    image2 = F.pad(2 * (image2 / 255.0) - 1.0, pad, mode="replicate")
    fmap1 = encoder(p, "fnet", image1)
    fmap2 = encoder(p, "fnet", image2)
    pyramid = corr_pyramid(fmap1.float(), fmap2.float())
    cnet = encoder(p, "cnet", image1)
    net, inp = torch.split(cnet, [HIDDEN, cnet.shape[1] - HIDDEN], dim=1)
    net, inp = torch.tanh(net), torch.relu(inp)
    n, _, h, w = fmap1.shape
    coords0 = coords_grid(n, h, w, image1.device)
    coords1 = coords_grid(n, h, w, image1.device)
    for _ in range(iters):
        corr = corr_lookup(pyramid, coords1)
        net, mask, delta = update(p, net, inp, corr, coords1 - coords0)
        coords1 = coords1 + delta
    up = upsample_flow(coords1 - coords0, mask)
    h8, w8 = up.shape[-2:]
    return coords1 - coords0, up[..., pad[2]:h8 - pad[3], pad[0]:w8 - pad[1]]
