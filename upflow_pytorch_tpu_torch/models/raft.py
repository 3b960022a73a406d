"""RAFT, Recurrent All-Pairs Field Transforms (Teed & Deng, ECCV 2020),
PyTorch/CUDA, the full model served by ``models/entry.py``.

princeton-vl/RAFT ``core/raft.py``, ``extractor.py``, ``update.py`` and
``corr.py`` at the published widths, with their module names, so a
published checkpoint's state dict (without DataParallel's ``module.``)
loads as it is:

- the images normalised as ``2 * (image / 255) - 1`` and padded by
  replication to a multiple of 8 (``InputPadder``, 'kitti' mode);
- ``fnet``: ``BasicEncoder(256, instance norm)``: a 7x7 stride-2 conv
  3->64, norm, ReLU; two ``ResidualBlock``s a layer at 64, 96 (stride 2)
  and 128 (stride 2) channels; a 1x1 conv 128->256.  ``cnet``: the same
  with batch norm (eval), 256 channels split into ``net = tanh`` and
  ``inp = relu``, 128 each;
- the all-pairs volume ``fmap1^T fmap2 / 16`` over the 1/8 grid and 3
  rounds of 2x2 average pooling over the second frame's pixels;
- ``iters`` updates: the 4-level radius-4 lookup at ``coords1``
  (``ops/kernels/corr_lookup.py``), ``BasicMotionEncoder``,
  ``SepConvGRU(128, 384)``, ``FlowHead`` and the mask head, and
  ``coords1 += delta``;
- convex upsampling of the last flow by the last mask (a softmax over 9
  an 8x8 sub-pixel), cropped to the frame.

Both directions run as one batch of 2B: each encoder sees both frames
once, the volume is ``bmm`` of the 2B maps against their swapped order,
and every update runs both.  ``forward`` returns ``(flow_f, flow_b,
flows)`` as ``UPFlowNet`` does, ``flows`` the final pair and the 1/8 pair,
finest first.  A width shard raises: the volume needs the whole frame.

Precision at ``compute_dtype='bfloat16'`` (RAFT's ``--mixed_precision``,
in bf16 where RAFT autocasts to fp16): every conv takes bf16 operands
and returns bf16 on the route of ``ops/conv.py::conv_bf16``, with ReLU
where UPFlow has LeakyReLU: the 3x3 stride-1 convs that meet
``uses_kernel`` run ``conv3x3_seg`` (fp32 sums, the bias and the ReLU in
fp32, one rounding), the rest a library conv with fp32 sums rounded to
bf16, then the bias added and the ReLU applied in bf16.  The norms
compute in fp32 and round their ReLU'd output once; the residual sums
are fp32.  The volume is fp32: a bf16-operand ``bmm`` with fp32 output on
the card (the maps are bf16 conv outputs, so their products are exact),
an fp32 one of the widened maps on the CPU; the 1/16 is applied to the
first map, exactly.  The lookup reads fp32 and writes bf16.  The
coordinates, the flow, the GRU's state and its gates (the sigmoids, tanh
and blend of the bf16 conv outputs) and the upsampling's softmax stay
fp32; the flow enters ``convf1`` and the GRU's input as bf16.

Two pairs of convs that read one input run as one conv each
(``Merged``): the GRU's ``convz`` and ``convr`` of each pass, and
``FlowHead.conv1`` with the mask head's first conv; their outputs are
channel ranges of one map (49.2 against 51.8 ms a bf16 request at
375x1242 on the H100).  At bf16 the update block writes into two buffers
instead of concatenating: ``hx`` (the GRU's input: ``[h | inp | motion |
flow]``, 384 channels, ``inp`` written once a request) and the motion
encoder's ``[cor | flo]``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from upflow_pytorch_tpu_torch.config import RAFTConfig
from upflow_pytorch_tpu_torch.ops.conv import conv_bf16
from upflow_pytorch_tpu_torch.ops.kernels._common import cached
from upflow_pytorch_tpu_torch.ops.kernels.conv3x3_seg import RELU
from upflow_pytorch_tpu_torch.ops.kernels.corr_lookup import corr_lookup
from upflow_pytorch_tpu_torch.utils.profiling import span


class Merged:
    """Layers of one input (convs, or Linears) run as one: their weights
    and biases (where they have them) concatenated along the outputs, in
    ``dtype`` when one is asked for, cached until a source parameter
    changes.  Not a module, so the state dict keeps the network's
    names."""

    def __init__(self, *layers: nn.Module):
        self.layers = layers
        self.stride = getattr(layers[0], "stride", None)
        self.padding = getattr(layers[0], "padding", None)

    def params(self, dtype: Optional[torch.dtype] = None
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        ls = self.layers
        sources = [p for m in ls for p in (m.weight, m.bias) if p is not None]

        def make():
            w = torch.cat([m.weight for m in ls])
            b = None if ls[0].bias is None else torch.cat([m.bias for m in ls])
            if dtype is None:
                return w, b
            return w.to(dtype), None if b is None else b.to(dtype)
        return cached(self, "_merged" if dtype is None
                      else "_merged_%s" % dtype, sources, make)


def _params(src) -> Tuple[torch.Tensor, torch.Tensor]:
    return src.params() if isinstance(src, Merged) else (src.weight,
                                                         src.bias)


def conv(src, x: torch.Tensor, relu: bool = False,
         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The conv ``src`` (an ``nn.Conv2d`` or ``Merged``) of ``x`` (+ ReLU),
    in ``x``'s dtype, at bf16 on ``ops/conv.py::conv_bf16``'s route; into
    ``out`` when it is given (a channel range of a buffer), which is
    returned."""
    w, b = _params(src)
    if x.dtype == torch.bfloat16:
        return conv_bf16(x, w, b, src.stride[0], src.padding, 1,
                         RELU if relu else False, out, src)
    y = F.conv2d(x, w, b, src.stride, src.padding)
    if relu:
        y = F.relu(y)
    return y if out is None else out.copy_(y)


def _norm(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Instance norm or eval batch norm of ``x``, in fp32."""
    x = x.float()
    if isinstance(module, nn.InstanceNorm2d):
        return F.instance_norm(x, eps=module.eps)
    return F.batch_norm(x, module.running_mean, module.running_var,
                        module.weight, module.bias, False, 0.0, module.eps)


def _make_norm(norm_fn: str, planes: int) -> nn.Module:
    return (nn.InstanceNorm2d(planes) if norm_fn == "instance"
            else nn.BatchNorm2d(planes))


class ResidualBlock(nn.Module):
    """conv3x3-norm-ReLU-conv3x3-norm-ReLU, plus a strided 1x1 conv and
    norm on the skip where the stride is 2, then ReLU of the sum.  The 3x3
    convs have a bias unless ``bias`` is False (GMFlow's ``backbone.py``);
    the skip's conv always has one."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str,
                 stride: int = 1, bias: bool = True):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, padding=1,
                               stride=stride, bias=bias)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=bias)
        self.norm1 = _make_norm(norm_fn, planes)
        self.norm2 = _make_norm(norm_fn, planes)
        self.downsample = None
        if stride != 1:
            self.norm3 = _make_norm(norm_fn, planes)
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=stride), self.norm3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(_norm(self.norm1, conv(self.conv1, x))).to(x.dtype)
        y = F.relu(_norm(self.norm2, conv(self.conv2, y)))
        skip = x.float() if self.downsample is None else _norm(
            self.norm3, conv(self.downsample[0], x))
        return F.relu(skip + y).to(x.dtype)


class BasicEncoder(nn.Module):
    """extractor.py's ``BasicEncoder``: 1/8 resolution, ``output_dim``
    channels, in the input's dtype.  With ``bias=False`` the 7x7 conv and
    the residual blocks' 3x3 convs have no bias: GMFlow's ``CNNEncoder``
    (``backbone.py``, one output scale), whose module names these are."""

    def __init__(self, output_dim: int, norm_fn: str,
                 dims: Sequence[int] = (64, 64, 96, 128), bias: bool = True):
        super().__init__()
        self.conv1 = nn.Conv2d(3, dims[0], 7, stride=2, padding=3, bias=bias)
        self.norm1 = _make_norm(norm_fn, dims[0])
        layers, cin = [], dims[0]
        for dim, stride in zip(dims[1:], (1, 2, 2)):
            layers.append(nn.Sequential(
                ResidualBlock(cin, dim, norm_fn, stride, bias),
                ResidualBlock(dim, dim, norm_fn, bias=bias)))
            cin = dim
        self.layer1, self.layer2, self.layer3 = layers
        self.conv2 = nn.Conv2d(cin, output_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(_norm(self.norm1, conv(self.conv1, x))).to(x.dtype)
        for layer in (self.layer1, self.layer2, self.layer3):
            for block in layer:
                x = block(x)
        return conv(self.conv2, x)


class BasicMotionEncoder(nn.Module):
    def __init__(self, cor_planes: int):
        super().__init__()
        self.convc1 = nn.Conv2d(cor_planes, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 128 - 2, 3, padding=1)


class SepConvGRU(nn.Module):
    def __init__(self, hidden_dim: int, input_dim: int):
        super().__init__()
        cin = hidden_dim + input_dim
        for name, k, p in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for gate in "zrq":
                setattr(self, "conv%s%s" % (gate, name),
                        nn.Conv2d(cin, hidden_dim, k, padding=p))


class FlowHead(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, 2, 3, padding=1)


class BasicUpdateBlock(nn.Module):
    """update.py's ``BasicUpdateBlock``; ``step`` runs it on the buffers
    of ``RAFTNet.forward``."""

    def __init__(self, cor_planes: int, hidden_dim: int):
        super().__init__()
        self.encoder = BasicMotionEncoder(cor_planes)
        self.gru = SepConvGRU(hidden_dim, 128 + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, 256)
        self.mask = nn.Sequential(nn.Conv2d(128, 256, 3, padding=1),
                                  nn.ReLU(inplace=True),
                                  nn.Conv2d(256, 64 * 9, 1))
        g = self.gru
        self.gru_zr = (Merged(g.convz1, g.convr1), Merged(g.convz2, g.convr2))
        self.heads = Merged(self.flow_head.conv1, self.mask[0])

    def step(self, h: torch.Tensor, hx: torch.Tensor, cf: torch.Tensor,
             corr: torch.Tensor, flow: torch.Tensor):
        """One update: ``h`` the fp32 GRU state, ``hx`` its input buffer
        (``h`` in the compute dtype, then ``inp``, written by the caller;
        the motion features and the flow, written here), ``cf`` the motion
        encoder's buffer, ``corr`` the lookup, ``flow`` fp32.  Returns the
        new state, the mask (x0.25) and the fp32 flow update."""
        enc, nh = self.encoder, h.shape[1]
        cor = conv(enc.convc1, corr, relu=True)
        conv(enc.convc2, cor, True, cf[:, :192])
        flo = conv(enc.convf1, flow.to(hx.dtype), relu=True)
        conv(enc.convf2, flo, True, cf[:, 192:])
        conv(enc.conv, cf, True, hx[:, 2 * nh:-2])
        hx[:, -2:] = flow
        g = self.gru
        for zr, convq in zip(self.gru_zr, (g.convq1, g.convq2)):
            gates = conv(zr, hx)
            z = torch.sigmoid(gates[:, :nh].float())
            r = torch.sigmoid(gates[:, nh:].float())
            hx[:, :nh] = r * h
            q = torch.tanh(conv(convq, hx).float())
            h = (1 - z) * h + z * q
            hx[:, :nh] = h
        heads = conv(self.heads, hx[:, :nh], relu=True)
        split = self.flow_head.conv1.out_channels
        delta = conv(self.flow_head.conv2, heads[:, :split]).float()
        mask = 0.25 * conv(self.mask[2], heads[:, split:])
        return h, mask, delta


def padding(h: int, w: int, factor: int = 8) -> List[int]:
    """``InputPadder(mode='kitti')``'s [left, right, top, bottom] to
    multiples of ``factor`` (RAFT's 8, GMFlow's ``padding_factor`` 16):
    the columns by halves, the rows at the bottom."""
    pad_h = (((h // factor) + 1) * factor - h) % factor
    pad_w = (((w // factor) + 1) * factor - w) % factor
    return [pad_w // 2, pad_w - pad_w // 2, 0, pad_h]


def unpad(x: torch.Tensor, pad: Sequence[int]) -> torch.Tensor:
    """``InputPadder.unpad``: the frame inside ``pad``."""
    h, w = x.shape[-2:]
    return x[..., pad[2]:h - pad[3], pad[0]:w - pad[1]]


def coords_grid(n: int, h: int, w: int, device) -> torch.Tensor:
    """(n, 2, h, w) fp32 pixel coordinates, x then y."""
    ys, xs = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing="ij")
    return torch.stack([xs, ys]).float()[None].repeat(n, 1, 1, 1)


def corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                 levels: int = 4) -> List[torch.Tensor]:
    """corr.py's ``CorrBlock`` volume: ``fmap1^T fmap2 / sqrt(C)`` per
    item as (N * H * W, 1, H, W) fp32, then ``levels - 1`` rounds of 2x2
    average pooling."""
    n, c, h, w = fmap1.shape
    a = (fmap1 * (1.0 / math.sqrt(c))).reshape(n, c, h * w).transpose(1, 2)
    b = fmap2.reshape(n, c, h * w)
    if a.is_cuda and a.dtype == torch.bfloat16:
        vol = torch.bmm(a, b, out_dtype=torch.float32)
    else:
        vol = torch.bmm(a.float(), b.float())
    pyramid = [vol.view(n * h * w, 1, h, w)]
    for _ in range(levels - 1):
        pyramid.append(F.avg_pool2d(pyramid[-1], 2, stride=2))
    return pyramid


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """raft.py's ``upsample_flow``: (N, 2, H, W) fp32 to (N, 2, 8H, 8W),
    each sub-pixel a softmax-weighted (fp32) sum of its 3x3 neighbours'
    ``8 * flow``."""
    n, _, h, w = flow.shape
    mask = torch.softmax(mask.float().view(n, 1, 9, 8, 8, h, w), dim=2)
    up = F.unfold(8 * flow, [3, 3], padding=1).view(n, 2, 9, 1, 1, h, w)
    up = torch.sum(mask * up, dim=2).permute(0, 1, 4, 2, 5, 3)
    return up.reshape(n, 2, 8 * h, 8 * w)


class RAFTNet(nn.Module):
    """RAFT, both directions of a pair in one batch.  ``RAFTNet.iterations``
    counts the update iterations run (each updates both directions of
    every item); like the kernels' launch counters it counts in Python,
    so at a graph's capture and not at its replays."""

    iterations = 0

    def __init__(self, conf: RAFTConfig = RAFTConfig(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conf = conf
        self.dtype = (torch.bfloat16 if conf.compute_dtype == "bfloat16"
                      else torch.float32)
        dims = conf.encoder_dims
        self.fnet = BasicEncoder(conf.feature_dim, "instance", dims)
        self.cnet = BasicEncoder(conf.hidden_dim + conf.context_dim, "batch",
                                 dims)
        self.update_block = BasicUpdateBlock(
            conf.corr_levels * (2 * conf.corr_radius + 1) ** 2,
            conf.hidden_dim)
        init_weights(self, generator)

    def forward(self, im1: torch.Tensor, im2: torch.Tensor, shard=None):
        """NCHW fp32 images (B, 3, H, W) in [0, 255] -> ``(flow_f,
        flow_b, flows)``: the (B, 2, H, W) flows of both directions and
        ``[(flow_f, flow_b), (the 1/8 grid's flows)]``."""
        if shard is not None:
            raise ValueError("RAFT takes no width shard: its all-pairs "
                             "volume needs the whole frame")
        conf, b = self.conf, im1.shape[0]
        nh, dt = conf.hidden_dim, self.dtype
        pad = padding(im1.shape[2], im1.shape[3])
        with span("upflow.raft.encoders"):
            x = 2 * (torch.cat([im1, im2]) / 255.0) - 1.0
            x = F.pad(x, pad, mode="replicate").to(dt)
            fmap = self.fnet(x)
            ctx = self.cnet(x)
            n, _, h, w = fmap.shape
            # the GRU's input: [h | inp | motion features | flow]
            hx = torch.empty((n, 3 * nh, h, w), dtype=dt, device=x.device)
            state = torch.tanh(ctx[:, :nh].float())
            hx[:, :nh] = state
            hx[:, nh:2 * nh] = F.relu(ctx[:, nh:])
        with span("upflow.raft.corr_volume"):
            pyramid = corr_pyramid(fmap, torch.cat([fmap[b:], fmap[:b]]),
                                   conf.corr_levels)
        cf = torch.empty((n, 256, h, w), dtype=dt, device=x.device)
        coords0 = coords_grid(n, h, w, x.device)
        coords1 = coords0
        for _ in range(conf.iters):
            with span("upflow.raft.lookup"):
                corr = corr_lookup(pyramid, coords1, dt)
            with span("upflow.raft.update"):
                state, mask, delta = self.update_block.step(
                    state, hx, cf, corr, coords1 - coords0)
                coords1 = coords1 + delta
            RAFTNet.iterations += 1
        with span("upflow.raft.upsample"):
            flow8 = coords1 - coords0
            up = unpad(convex_upsample(flow8, mask), pad).contiguous()
        return up[:b], up[b:], [(up[:b], up[b:]), (flow8[:b], flow8[b:])]


def init_weights(model: nn.Module,
                 generator: Optional[torch.Generator] = None) -> None:
    """RAFT's initialisation, drawn from ``generator``: the encoders'
    convs Kaiming-normal (fan out, ReLU), the other convs' weights and
    every conv's bias PyTorch's default (uniform within 1 / sqrt(fan
    in)).  Batch norm's affine parameters and running statistics are
    drawn too (weight and variance uniform in [0.5, 1.5], bias and mean
    normal with sd 0.1), so that its eval-mode fold does real work; the
    instance norms have no parameters."""
    g = generator
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, nn.Conv2d):
                k = m.kernel_size[0] * m.kernel_size[1]
                bound = 1.0 / math.sqrt(m.in_channels * k)
                if name.startswith(("fnet.", "cnet.")):
                    m.weight.normal_(0.0, math.sqrt(2.0 / (m.out_channels
                                                           * k)),
                                     generator=g)
                else:
                    m.weight.uniform_(-bound, bound, generator=g)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=g)
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)


def load_state(model: RAFTNet, path: str) -> None:
    """A RAFT state dict saved with ``torch.save`` (a published checkpoint,
    whose keys may carry DataParallel's ``module.``), loaded strictly."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict({k[len("module."):] if k.startswith("module.")
                           else k: v for k, v in sd.items()}, strict=True)
