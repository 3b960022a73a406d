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
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn


class ConvBlock(nn.Sequential):
    """Conv (+ LeakyReLU(0.1) unless ``relu=False``)."""

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

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        pyramid = []
        for level in self.convs:
            x = level(x)
            pyramid.append(x)
        return pyramid[::-1]


class FlowEstimatorDense(nn.Module):
    """DenseNet-style estimator: 5 convs with concat-skips plus a linear
    head.  Returns ``(features, flow_residual)``."""

    def __init__(self, ch_in: int,
                 f_channels: Sequence[int] = (128, 128, 96, 64, 32),
                 out_channels: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = ch_in
        for i, f in enumerate(f_channels):
            setattr(self, "conv%d" % (i + 1),
                    ConvBlock(c, f, generator=generator))
            c += f
        self.n_convs = len(f_channels)
        self.feat_dim = c
        self.conv_last = ConvBlock(c, out_channels, relu=False,
                                   generator=generator)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        for i in range(self.n_convs):
            x = torch.cat([getattr(self, "conv%d" % (i + 1))(x), x], dim=1)
        return x, self.conv_last(x)


class ContextNetwork(nn.Module):
    """7 convs with dilations (1, 2, 4, 8, 16, 1, 1); the last is linear."""

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.convs(x)


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


class SGUModel(nn.Module):
    """The self-guided upsampling weights (the reference's ``sgu_model``)."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dense_estimator_mask = SGUDenseEstimator(generator)
        self.upsample_output_conv = SGUOutputConv(generator)
