"""RAFT's bidirectional forward in plain fp32 PyTorch: the reference that
decides ``correct`` in the RAFT cells.

princeton-vl/RAFT (Teed & Deng, ECCV 2020) ``core/raft.py``,
``extractor.py``, ``update.py`` and ``corr.py``, the full model, written
as functions of a flat parameter dict keyed by RAFT's own module names (a
state dict), NCHW.  It imports neither JAX nor the program.  Its weights
are drawn here (``init_params``, RAFT's initialisation from a seed) and
loaded into the program, never taken from it.  Callers switch TF32 off
(``upflow.fp32``).  ``forward``'s ``quant`` rounds each conv's input and
weight (a control's lower precision, ``lowp.CONTROLS``); it travels in
the parameter dict under the key ``"quant"``.  ``forward`` serves a
pair both ways and adds UPFlow's occlusion check (``upflow.occlusion``),
as the program's entry does.

Departures from ``core/*.py``, none of which changes a value: one
direction and one pair a call (``raft(p, im1, im2)``), as published; the
images padded here (``InputPadder``) and the flow cropped back; the flow
upsampled once, after the last iteration, where RAFT upsamples every
iteration and test mode returns the last; no autocast (fp32 throughout).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.upflow import occlusion

Params = Dict[str, torch.Tensor]  # and "quant": Quant
Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]

HIDDEN = 128
RADIUS = 4
LEVELS = 4


def state_shapes(widths: Mapping[str, Any]) -> Dict[str, tuple]:
    """RAFT's state dict, key by key, as shapes: from the configuration's
    ``feature_dim``, ``hidden_dim``, ``context_dim``, ``encoder_dims``,
    ``corr_levels`` and ``corr_radius``, and the widths that
    ``update.py`` fixes.  A batch norm's keys, ``num_batches_tracked`` the
    only scalar, appear under its own name and, for a strided block's skip
    norm, also as ``downsample.1``, as ``nn.Module.state_dict`` lists
    them."""
    out: Dict[str, tuple] = {}

    def conv_(name, cout, cin, kh, kw):
        out[name + ".weight"] = (cout, cin, kh, kw)
        out[name + ".bias"] = (cout,)

    def norm_(name, c, batch):
        if batch:
            for key in ("weight", "bias", "running_mean", "running_var"):
                out["%s.%s" % (name, key)] = (c,)
            out[name + ".num_batches_tracked"] = ()

    dims = list(widths["encoder_dims"])
    for enc, dim, batch in (("fnet", widths["feature_dim"], False),
                            ("cnet", widths["hidden_dim"]
                             + widths["context_dim"], True)):
        conv_(enc + ".conv1", dims[0], 3, 7, 7)
        norm_(enc + ".norm1", dims[0], batch)
        cin = dims[0]
        for layer, (planes, stride) in enumerate(zip(dims[1:], (1, 2, 2))):
            for i in range(2):
                name = "%s.layer%d.%d" % (enc, layer + 1, i)
                conv_(name + ".conv1", planes, cin, 3, 3)
                conv_(name + ".conv2", planes, planes, 3, 3)
                norm_(name + ".norm1", planes, batch)
                norm_(name + ".norm2", planes, batch)
                if i == 0 and stride != 1:
                    norm_(name + ".norm3", planes, batch)
                    conv_(name + ".downsample.0", planes, cin, 1, 1)
                    norm_(name + ".downsample.1", planes, batch)
                cin = planes
        conv_(enc + ".conv2", dim, cin, 1, 1)
    hidden = widths["hidden_dim"]
    cor = widths["corr_levels"] * (2 * widths["corr_radius"] + 1) ** 2
    e = "update_block.encoder."
    conv_(e + "convc1", 256, cor, 1, 1)
    conv_(e + "convc2", 192, 256, 3, 3)
    conv_(e + "convf1", 128, 2, 7, 7)
    conv_(e + "convf2", 64, 128, 3, 3)
    conv_(e + "conv", 128 - 2, 64 + 192, 3, 3)
    gru_in = hidden + 128 + widths["context_dim"]
    for k, (kh, kw) in (("1", (1, 5)), ("2", (5, 1))):
        for gate in "zrq":
            conv_("update_block.gru.conv%s%s" % (gate, k), hidden, gru_in,
                  kh, kw)
    conv_("update_block.flow_head.conv1", 256, hidden, 3, 3)
    conv_("update_block.flow_head.conv2", 2, 256, 3, 3)
    conv_("update_block.mask.0", 256, 128, 3, 3)
    conv_("update_block.mask.2", 64 * 9, 256, 1, 1)
    return out


def init_params(seed: int, widths: Mapping[str, Any]) -> Params:
    """RAFT's initialisation, drawn from ``seed``: the encoders' conv
    weights Kaiming-normal (fan out, ReLU) as ``extractor.py`` sets them;
    every other conv weight and every conv bias PyTorch's default, uniform
    within 1 / sqrt(fan in).  Batch norm's weight and running variance are
    drawn uniform in [0.5, 1.5], its bias and running mean normal with sd
    0.1, so that its eval-mode fold does real work (RAFT sets weight 1 and
    bias 0); a strided block's ``downsample.1`` is its ``norm3``.  fp32."""
    rng = np.random.default_rng([seed, 3])
    shapes = state_shapes(widths)
    p: Params = {}
    for key, shape in shapes.items():
        name, _, kind = key.rpartition(".")
        w = shapes.get(name + ".weight", ())
        if name.endswith("downsample.1"):
            p[key] = p[name[:-len("downsample.1")] + "norm3." + kind]
            continue
        if kind == "num_batches_tracked":
            p[key] = torch.zeros((), dtype=torch.int64)
            continue
        if len(w) == 4 and kind == "weight" and name.startswith(
                ("fnet.", "cnet.")):
            v = rng.normal(0.0, math.sqrt(2.0 / (w[0] * w[2] * w[3])), shape)
        elif len(w) == 4:  # a conv's weight or bias
            bound = 1.0 / math.sqrt(w[1] * w[2] * w[3])
            v = rng.uniform(-bound, bound, shape)
        elif kind in ("weight", "running_var"):
            v = rng.uniform(0.5, 1.5, shape)
        else:  # a batch norm's bias or running mean
            v = rng.normal(0.0, 0.1, shape)
        p[key] = torch.from_numpy(np.asarray(v, np.float32))
    return p


def conv(p: Params, name: str, x: torch.Tensor, stride: int = 1,
         padding=0) -> torch.Tensor:
    w = p[name + ".weight"]
    quant = p.get("quant")
    if quant is not None:
        x, w = quant(x), quant(w)
    return F.conv2d(x, w, p[name + ".bias"], stride, padding)


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


def forward(p: Params, im1: torch.Tensor, im2: torch.Tensor, iters: int,
            quant: Quant = None) -> Dict[str, torch.Tensor]:
    """The served outputs for NHWC fp32 images in [0, 255]: NHWC
    ``flow_f_out``, ``flow_b_out`` (B, H, W, 2), ``occ_fw``, ``occ_bw``
    (B, H, W, 1)."""
    p = dict(p, quant=quant)
    a = im1.permute(0, 3, 1, 2).contiguous()
    b = im2.permute(0, 3, 1, 2).contiguous()
    # a pair at a time, as evaluate.py runs it: at a batch of 4, cuDNN's
    # fp32 algorithms for the update block's convs ran 260x slower on the
    # H100 (624 ms an update against 2.4)
    flow_f = torch.cat([raft(p, a[i:i + 1], b[i:i + 1], iters)[1]
                        for i in range(a.shape[0])])
    flow_b = torch.cat([raft(p, b[i:i + 1], a[i:i + 1], iters)[1]
                        for i in range(a.shape[0])])
    occ_f, occ_b = occlusion(flow_f, flow_b)
    return {k: v.permute(0, 2, 3, 1) for k, v in (
        ("flow_f_out", flow_f), ("flow_b_out", flow_b),
        ("occ_fw", occ_f), ("occ_bw", occ_b))}
