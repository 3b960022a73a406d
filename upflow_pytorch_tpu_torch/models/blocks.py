"""UPFlow building blocks as PyTorch modules (NCHW).

Module and attribute names follow the reference torch state-dict keys, so
a reference state dict loads 1:1:

- ``ConvBlock``           ``conv()``: ``nn.Conv2d`` (bias) + LeakyReLU(0.1);
  its conv is child ``0``
- ``FeatureExtractor``    ``convs.L`` = two ConvBlocks (stride 2, 1)
- ``FlowEstimatorDense``  ``conv1`` .. ``conv5``, ``conv_last``; new
  features are concatenated BEFORE the running input (``cat([conv(x), x])``)
- ``ContextNetwork``      ``convs.0`` .. ``convs.6``, dilations
  1, 2, 4, 8, 16, 1, 1
- ``SGUModel``            ``dense_estimator_mask`` (``SGUDenseEstimator``)
  and ``upsample_output_conv.0`` .. ``.3`` (``SGUOutputConv``); the
  network holds it as ``sgi_model``

Every conv pads ``((k-1)*d)//2`` and is initialised Kaiming-normal
(fan_in, std = sqrt(2 / fan_in)) with zero bias, drawn from the
``torch.Generator`` the caller passes.

The compute dtype is the input's: parameters stay fp32, and a bf16 input
runs every conv at bf16 (``ops/conv.py``: ``conv3x3_seg`` or the
plain-conv route, as the JAX package's ``ConvBlock`` chooses), with bf16
outputs.  At bf16 the dense estimators keep their features in one
preallocated buffer (``FlowEstimatorDense.dense_buffer``): each conv reads
a channel range of it and writes its output into the slot in front, so no
concatenation is copied.  The fp32 path concatenates as the reference
does, and so does the bf16 path under autograd, which cannot follow the
buffer's in-place slot writes (``FlowEstimatorDense.dense_input``); the
values are the same.

Every block takes ``cols`` (``ops/columns.py::Columns``) for a frame
whose width is sharded: the input is this rank's columns of a map
``cols.width`` wide, and each conv reads the window its output columns
need (``conv_window``: a halo of the dilation, a stride-2 conv's input
span), zero outside the frame, and convolves it with no column padding.
At bf16 the dense buffer keeps its slot writes, each conv reading the
window of its channel range.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from upflow_pytorch_tpu_torch.ops.conv import conv_bf16
from upflow_pytorch_tpu_torch.ops.columns import conv_width, conv_window


class ConvBlock(nn.Sequential):
    """Conv (+ LeakyReLU(0.1) unless ``relu=False``).  At bf16 the output
    goes into ``out`` when it is given (a channel slot of a buffer); at
    fp32 ``out`` is not taken.  On the ``conv3x3_seg`` route the block
    keeps the kernel's packed weights (``packed_params``), packed at its
    first call and again only after its parameters change."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1, relu: bool = True,
                 generator: Optional[torch.Generator] = None):
        pad = ((kernel_size - 1) * dilation) // 2
        conv = nn.Conv2d(cin, cout, kernel_size, stride=stride, padding=pad,
                         dilation=dilation, bias=True)
        with torch.no_grad():
            std = math.sqrt(2.0 / (cin * kernel_size * kernel_size))
            conv.weight.normal_(0.0, std, generator=generator)
            conv.bias.zero_()
        layers: List[nn.Module] = [conv]
        if relu:
            layers.append(nn.LeakyReLU(0.1))
        super().__init__(*layers)
        self.relu = relu

    def forward(self, x: torch.Tensor, out: Optional[torch.Tensor] = None,
                cols=None) -> torch.Tensor:
        conv = self[0]
        k, s, p, d = (conv.kernel_size[0], conv.stride[0], conv.padding[0],
                      conv.dilation[0])
        width = None
        if cols is not None:
            x = conv_window(x, cols, k, s, p, d)
            width = cols.width
        if x.dtype == torch.bfloat16:
            return conv_bf16(x, conv.weight, conv.bias, s, p, d, self.relu,
                             out, owner=self, width=width)
        if cols is None:
            return super().forward(x)
        y = F.conv2d(x, conv.weight, conv.bias, s, (p, 0), d)
        return F.leaky_relu(y, 0.1) if self.relu else y

    def out_width(self, width: int) -> int:
        """The output's width for an input ``width`` columns wide."""
        conv = self[0]
        return conv_width(width, conv.kernel_size[0], conv.stride[0],
                          conv.padding[0], conv.dilation[0])

    def out_cols(self, cols):
        """The output's ``Columns`` for an input on ``cols`` (None stays
        None)."""
        return None if cols is None else cols.to(self.out_width(cols.width))


class FeatureExtractor(nn.Module):
    """6-level pyramid encoder; returns features COARSEST-FIRST.
    Channels (3,)16,32,64,96,128,196."""

    def __init__(self, num_chs: Sequence[int] = (3, 16, 32, 64, 96, 128, 196),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.convs = nn.ModuleList(
            nn.Sequential(ConvBlock(cin, cout, stride=2, generator=generator),
                          ConvBlock(cout, cout, generator=generator))
            for cin, cout in zip(num_chs[:-1], num_chs[1:]))

    def forward(self, x: torch.Tensor, cols=None) -> List[torch.Tensor]:
        pyramid = []
        for level in self.convs:
            for block in level:
                x = block(x, cols=cols)
                cols = block.out_cols(cols)
            pyramid.append(x)
        return pyramid[::-1]

    def level_widths(self, width: int) -> List[int]:
        """The global widths of the levels, COARSEST-FIRST, for a frame
        ``width`` columns wide."""
        widths = []
        for level in self.convs:
            for block in level:
                width = block.out_width(width)
            widths.append(width)
        return widths[::-1]


class FlowEstimatorDense(nn.Module):
    """DenseNet-style estimator: 5 convs with concat-skips plus a linear
    head.  Returns ``(features, flow_residual)``.

    ``x`` is the input (B, ch_in, H, W), fp32 or bf16, or at bf16 a wider
    dense buffer from ``dense_buffer``, whose first ``feat_dim`` channels
    are then the features."""

    def __init__(self, ch_in: int,
                 f_channels: Sequence[int] = (128, 128, 96, 64, 32),
                 out_channels: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.ch_in = c = ch_in
        for i, f in enumerate(f_channels):
            setattr(self, "conv%d" % (i + 1),
                    ConvBlock(c, f, generator=generator))
            c += f
        self.n_convs = len(f_channels)
        self.feat_dim = c
        self.conv_last = ConvBlock(c, out_channels, relu=False,
                                   generator=generator)

    def dense_buffer(self, segments: Sequence[torch.Tensor],
                     extra: int = 0) -> torch.Tensor:
        """A bf16 (B, feat_dim + extra, H, W) buffer with ``segments``
        (the input, ch_in channels in all) cast into channels
        [feat_dim - ch_in, feat_dim); the rest is left for the convs and
        the caller."""
        b, _, h, w = segments[0].shape
        buf = segments[0].new_empty((b, self.feat_dim + extra, h, w),
                                    dtype=torch.bfloat16)
        c = self.feat_dim - self.ch_in
        for s in segments:
            buf[:, c:c + s.shape[1]] = s
            c += s.shape[1]
        return buf

    def dense_input(self, segments: Sequence[torch.Tensor],
                    extra: int = 0) -> torch.Tensor:
        """The bf16 input of ``segments``: under autograd their
        concatenation, otherwise a dense buffer (``dense_buffer``)."""
        if torch.is_grad_enabled():
            return torch.cat([s.to(torch.bfloat16) for s in segments], dim=1)
        return self.dense_buffer(segments, extra)

    def forward(self, x: torch.Tensor,
                cols=None) -> Tuple[torch.Tensor, torch.Tensor]:
        if x.dtype != torch.bfloat16 or x.shape[1] == self.ch_in:
            for i in range(self.n_convs):
                x = torch.cat([getattr(self, "conv%d" % (i + 1))(
                    x, cols=cols), x], dim=1)
            return x, self.conv_last(x, cols=cols)
        # cat([conv(x), x]) order: conv i reads [start, feat_dim) and
        # writes the slot just in front of it
        start = self.feat_dim - self.ch_in
        for i in range(self.n_convs):
            conv = getattr(self, "conv%d" % (i + 1))
            f = conv[0].out_channels
            conv(x[:, start:self.feat_dim], out=x[:, start - f:start],
                 cols=cols)
            start -= f
        feat = x[:, :self.feat_dim]
        return feat, self.conv_last(feat, cols=cols)


class ContextNetwork(nn.Module):
    """7 convs with dilations (1, 2, 4, 8, 16, 1, 1); the last is linear.
    At bf16 ``x`` may be the estimator's dense buffer, whose features and
    last two channels (the flow) are the input."""

    def __init__(self, ch_in: int,
                 f_channels: Sequence[int] = (128, 128, 128, 96, 64, 32, 2),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dilations = (1, 2, 4, 8, 16, 1, 1)
        blocks, c = [], ch_in
        for i, (f, d) in enumerate(zip(f_channels, dilations)):
            blocks.append(ConvBlock(c, f, dilation=d,
                                    relu=i < len(f_channels) - 1,
                                    generator=generator))
            c = f
        self.convs = nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor, cols=None) -> torch.Tensor:
        for block in self.convs:
            x = block(x, cols=cols)
        return x


class SGUDenseEstimator(FlowEstimatorDense):
    """``FlowEstimatorDense_temp``: ch_in 64 (the 1x1 features of one
    frame, then the other's warped), f_channels (32, 32, 32, 16, 8), a
    3-channel head (inter-flow and mask logit)."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__(64, (32, 32, 32, 16, 8), 3, generator)


class SGUOutputConv(nn.Sequential):
    """``upsample_output_conv``: raw RGB -> 1/4-resolution 32 channels."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__(*(ConvBlock(cin, cout, stride=s, generator=generator)
                           for cin, cout, s in ((3, 16, 1), (16, 16, 2),
                                                (16, 32, 1), (32, 32, 2))))

    def forward(self, x: torch.Tensor, cols=None) -> torch.Tensor:
        for block in self:
            x = block(x, cols=cols)
            cols = block.out_cols(cols)
        return x

    def out_cols(self, cols):
        """The output's ``Columns`` for an input on ``cols``."""
        for block in self:
            cols = block.out_cols(cols)
        return cols


class SGUModel(nn.Module):
    """The self-guided upsampling weights (the reference's ``sgu_model``)."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dense_estimator_mask = SGUDenseEstimator(generator)
        self.upsample_output_conv = SGUOutputConv(generator)
