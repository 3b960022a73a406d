"""GMFlow, optical flow by global matching (Xu, Zhang, Cai, Rezatofighi and
Tao, CVPR 2022), PyTorch/CUDA, served by ``models/entry.py``.

haofeixu/gmflow ``gmflow/gmflow.py``, ``backbone.py``, ``transformer.py``,
``matching.py``, ``position.py`` and ``utils.py``, the model of the
published ``gmflow_kitti`` checkpoint (one scale, ``attn_splits_list
[2]``, ``corr_radius_list [-1]``, ``prop_radius_list [-1]``) at its
published widths, with its module names, so that a published state dict
loads as it is:

- the images padded by replication to a multiple of 16 (``InputPadder``,
  'kitti' mode) and normalised by ImageNet's mean and std;
- ``backbone``: ``CNNEncoder``, RAFT's ``BasicEncoder`` with instance
  norm and no bias in the 7x7 conv and the residual blocks' 3x3 convs
  (``models/raft.py``): 1/8 resolution, 128 channels;
- the sine position code (DETR's, normalised, 64 y then 64 x channels)
  added in each of the 2 x 2 windows;
- ``transformer``: 6 blocks over the tokens of both frames, each a
  self-attention and a cross-attention with a feed-forward layer, one
  head of 128, within 2 x 2 windows and, in blocks 1, 3 and 5, within
  Swin's shifted windows under their mask (``ops/attention.py``);
- global matching: a softmax over every position of the other frame of
  the features' products / sqrt(128), the flow its expected position
  less the pixel's own;
- ``feature_flow_attn``: the flow propagated by a softmax over every
  position of the frame (global), the key projected from the query as
  published;
- ``upsampler``: convex upsampling by 8 over a mask from the flow and the
  features, cropped to the frame.

Both directions run as one batch of 2B, as GMFlow's ``pred_bidir_flow``
runs them: the backbone sees both frames once, the Transformer updates
``[f0; f1]`` against ``[f1; f0]``, the matching is one call of
``ops/kernels/global_match.py`` over the first frames against the second
and the second against the first (the softmax of the transposed
correlation), and the propagation one call over both.  ``forward`` returns
``(flow_f, flow_b, flows)`` as ``UPFlowNet`` does, ``flows`` the final
pair and the 1/8 pair, finest first.  A width shard raises: the matching
needs the whole frame.

Precision at ``compute_dtype='bfloat16'`` (GMFlow's published eval is
fp32): bf16 operands with fp32 sums for every conv (``models/raft.py::
conv``, on ``ops/conv.py::conv_bf16``'s routes), every Linear (a bf16
product, rounded once) and the attention and matching products; fp32 for
the statistics of the instance and layer norms and of every softmax, the
residual stream between the Transformer's layers, the grid, the flow and
the upsampling.  The flow enters the upsampler's conv as bf16.

``GMFlowNet.attention_calls`` counts the attention calls by kind
("window", "shifted_window", "global_match", "propagate": 6, 6, 1 and 1 a
request); like the kernels' launch counters it counts in Python, so at a
graph's capture and not at its replays.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from upflow_pytorch_tpu_torch.config import GMFlowConfig
from upflow_pytorch_tpu_torch.models.raft import (
    BasicEncoder, Merged, conv, convex_upsample, padding, unpad)
from upflow_pytorch_tpu_torch.ops.attention import (
    attend, from_windows, shift_window_mask, to_windows)
from upflow_pytorch_tpu_torch.ops.kernels.global_match import global_match
from upflow_pytorch_tpu_torch.ops.resize import device_constant
from upflow_pytorch_tpu_torch.utils.profiling import span

MEAN = (0.485, 0.456, 0.406)  # ImageNet's, as utils.py normalises
STD = (0.229, 0.224, 0.225)
ATTENTION_KINDS = ("window", "shifted_window", "global_match", "propagate")


def linear(src: Merged, x: torch.Tensor) -> torch.Tensor:
    """``src``'s product with ``x`` (+ bias) in ``x``'s dtype: at bf16 a
    bf16 product with fp32 sums, rounded once (on the CPU the fp32 product
    of the bf16 values, rounded)."""
    w, b = src.params(x.dtype)
    if x.dtype == torch.bfloat16 and not x.is_cuda:
        return F.linear(x.float(), w.float(),
                        None if b is None else b.float()).to(x.dtype)
    return F.linear(x, w, b)


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """``norm`` of ``x`` in fp32."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight,
                        norm.bias, norm.eps)


def count(kind: str) -> None:
    GMFlowNet.attention_calls[kind] += 1


class TransformerLayer(nn.Module):
    """``transformer.py``'s ``TransformerLayer``, one head, window
    attention: attention of the source's queries to the target's keys and
    values, ``merge``, ``norm1``; with the feed-forward layer (``no_ffn``
    False) an MLP of ``[source, message]`` and ``norm2``; the output is
    ``source + message``."""

    def __init__(self, d_model: int, no_ffn: bool, ffn_dim_expansion: int,
                 with_shift: bool):
        super().__init__()
        self.with_shift, self.no_ffn = with_shift, no_ffn
        self.q_proj = nn.Linear(d_model, d_model, bias=False)
        self.k_proj = nn.Linear(d_model, d_model, bias=False)
        self.v_proj = nn.Linear(d_model, d_model, bias=False)
        self.merge = nn.Linear(d_model, d_model, bias=False)
        self.norm1 = nn.LayerNorm(d_model)
        if not no_ffn:
            width = 2 * d_model
            self.mlp = nn.Sequential(
                nn.Linear(width, width * ffn_dim_expansion, bias=False),
                nn.GELU(),
                nn.Linear(width * ffn_dim_expansion, d_model, bias=False))
            self.norm2 = nn.LayerNorm(d_model)
            self.ffn = (Merged(self.mlp[0]), Merged(self.mlp[2]))
        self.qkv = Merged(self.q_proj, self.k_proj, self.v_proj)
        self.q = Merged(self.q_proj)
        self.kv = Merged(self.k_proj, self.v_proj)
        self.out = Merged(self.merge)

    def forward(self, source: torch.Tensor, target: Optional[torch.Tensor],
                h: int, w: int, splits: int, dtype: torch.dtype
                ) -> torch.Tensor:
        """``source`` (N, H * W, C) fp32 tokens of an H x W map; ``target``
        the same, or None for self-attention (the source's)."""
        c, shift = source.shape[-1], self.with_shift
        x = source.to(dtype)
        if target is None:
            q, k, v = to_windows(linear(self.qkv, x), h, w, splits,
                                 shift).split(c, dim=-1)
        else:
            q = to_windows(linear(self.q, x), h, w, splits, shift)
            k, v = to_windows(linear(self.kv, target.to(dtype)), h, w,
                              splits, shift).split(c, dim=-1)
        mask = (shift_window_mask(h, w, splits, dtype, x.device) if shift
                else None)
        msg = from_windows(attend(q, k, v, mask), h, w, splits, shift)
        count("shifted_window" if shift else "window")
        msg = layer_norm(self.norm1, linear(self.out, msg))
        if not self.no_ffn:
            hidden = F.gelu(linear(self.ffn[0],
                                   torch.cat([x, msg.to(dtype)], dim=-1)))
            msg = layer_norm(self.norm2, linear(self.ffn[1], hidden))
        return source + msg


class TransformerBlock(nn.Module):
    """Self-attention, then cross-attention with the feed-forward layer."""

    def __init__(self, d_model: int, ffn_dim_expansion: int,
                 with_shift: bool):
        super().__init__()
        self.self_attn = TransformerLayer(d_model, True, ffn_dim_expansion,
                                          with_shift)
        self.cross_attn_ffn = TransformerLayer(d_model, False,
                                               ffn_dim_expansion, with_shift)

    def forward(self, source, target, h, w, splits, dtype):
        source = self.self_attn(source, None, h, w, splits, dtype)
        return self.cross_attn_ffn(source, target, h, w, splits, dtype)


def swap(x: torch.Tensor) -> torch.Tensor:
    """``[a; b]`` on the batch to ``[b; a]``."""
    half = x.shape[0] // 2
    return torch.cat([x[half:], x[:half]])


class FeatureTransformer(nn.Module):
    """``transformer.py``'s ``FeatureTransformer`` on the tokens of both
    frames: each block updates ``[f0; f1]`` from itself and ``[f1; f0]``,
    the shifted windows in the odd blocks."""

    def __init__(self, num_layers: int, d_model: int,
                 ffn_dim_expansion: int):
        super().__init__()
        self.layers = nn.ModuleList([
            TransformerBlock(d_model, ffn_dim_expansion, i % 2 == 1)
            for i in range(num_layers)])

    def forward(self, tokens: torch.Tensor, h: int, w: int, splits: int,
                dtype: torch.dtype) -> torch.Tensor:
        target = swap(tokens)
        for layer in self.layers:
            tokens = layer(tokens, target, h, w, splits, dtype)
            target = swap(tokens)
        return tokens


class FeatureFlowAttention(nn.Module):
    """``FeatureFlowAttention``'s projections; the propagation itself is
    ``GMFlowNet.forward``'s ``global_match`` call."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.q_proj = nn.Linear(in_channels, in_channels)
        self.k_proj = nn.Linear(in_channels, in_channels)
        self.q, self.k = Merged(self.q_proj), Merged(self.k_proj)


@device_constant(maxsize=16)
def position_code(c: int, h: int, w: int, splits: int,
                  device: torch.device) -> torch.Tensor:
    """(C, H, W) fp32: ``position.py::PositionEmbeddingSine(C / 2)`` of a
    window of H / splits x W / splits, repeated in each window as
    ``utils.py::feature_add_position`` adds it."""
    hs, ws, feats = h // splits, w // splits, c // 2
    ones = torch.ones((1, hs, ws))
    y = ones.cumsum(1, dtype=torch.float32)
    x = ones.cumsum(2, dtype=torch.float32)
    y = y / (y[:, -1:, :] + 1e-6) * (2 * math.pi)
    x = x / (x[:, :, -1:] + 1e-6) * (2 * math.pi)
    dim_t = torch.arange(feats, dtype=torch.float32)
    dim_t = 10000 ** (2 * (dim_t // 2) / feats)
    px, py = x[..., None] / dim_t, y[..., None] / dim_t
    px = torch.stack((px[..., 0::2].sin(), px[..., 1::2].cos()),
                     dim=4).flatten(3)
    py = torch.stack((py[..., 0::2].sin(), py[..., 1::2].cos()),
                     dim=4).flatten(3)
    pos = torch.cat((py, px), dim=3).permute(0, 3, 1, 2)[0]
    return pos.repeat(1, splits, splits).contiguous().to(device)


@device_constant(maxsize=16)
def normaliser(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """ImageNet's mean and std as (1, 3, 1, 1) fp32 on ``device``."""
    return (torch.tensor(MEAN).view(1, 3, 1, 1).to(device),
            torch.tensor(STD).view(1, 3, 1, 1).to(device))


@device_constant(maxsize=16)
def token_grid(n: int, h: int, w: int, device: torch.device) -> torch.Tensor:
    """(N, H * W, 2) fp32: each token's pixel (x, y) on the grid."""
    ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    grid = torch.stack([xs, ys], dim=-1).float().view(1, h * w, 2)
    return grid.repeat(n, 1, 1).to(device)


class GMFlowNet(nn.Module):
    """GMFlow, both directions of a pair in one batch."""

    attention_calls = dict.fromkeys(ATTENTION_KINDS, 0)

    def __init__(self, conf: GMFlowConfig = GMFlowConfig(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conf = conf
        self.dtype = (torch.bfloat16 if conf.compute_dtype == "bfloat16"
                      else torch.float32)
        c = conf.feature_channels
        dims = conf.backbone_dims
        self.backbone = BasicEncoder(c, "instance", dims[:1] + dims,
                                     bias=False)
        self.transformer = FeatureTransformer(
            conf.num_transformer_layers, c, conf.ffn_dim_expansion)
        self.feature_flow_attn = FeatureFlowAttention(c)
        factor = conf.upsample_factor
        self.upsampler = nn.Sequential(
            nn.Conv2d(2 + c, 256, 3, 1, 1), nn.ReLU(inplace=True),
            nn.Conv2d(256, factor ** 2 * 9, 1, 1, 0))
        init_weights(self, generator)

    def forward(self, im1: torch.Tensor, im2: torch.Tensor, shard=None):
        """NCHW fp32 images (B, 3, H, W) in [0, 255] -> ``(flow_f,
        flow_b, flows)``: the (B, 2, H, W) flows of both directions and
        ``[(flow_f, flow_b), (the 1/8 grid's flows)]``."""
        if shard is not None:
            raise ValueError("GMFlow takes no width shard: its global "
                             "matching needs the whole frame")
        conf, b, dt = self.conf, im1.shape[0], self.dtype
        splits = conf.attn_splits
        pad = padding(im1.shape[2], im1.shape[3], conf.padding_factor)
        with span("upflow.gmflow.encoder"):
            x = F.pad(torch.cat([im1, im2]), pad, mode="replicate")
            mean, std = normaliser(x.device)
            feat = self.backbone(((x / 255.0 - mean) / std).to(dt))
        n, c, h, w = feat.shape
        with span("upflow.gmflow.transformer"):
            tokens = (feat.float() + position_code(c, h, w, splits, x.device)
                      ).flatten(2).transpose(1, 2).contiguous()
            tokens = self.transformer(tokens, h, w, splits, dt)
        scale = 1.0 / math.sqrt(c)
        with span("upflow.gmflow.match"):
            f = tokens.to(dt)
            grid = token_grid(n, h, w, x.device)
            flow = global_match(f, swap(f), grid, scale) - grid
            count("global_match")
        with span("upflow.gmflow.propagate"):
            ffa = self.feature_flow_attn
            query = linear(ffa.q, f)
            flow = global_match(query, linear(ffa.k, query), flow, scale)
            count("propagate")
        with span("upflow.gmflow.upsample"):
            flow8 = flow.transpose(1, 2).reshape(n, 2, h, w)
            # [flow | features], NCHW: the upsampler's input
            x = torch.empty((n, 2 + c, h, w), dtype=dt, device=f.device)
            x[:, :2] = flow8
            x[:, 2:] = f.transpose(1, 2).view(n, c, h, w)
            mask = conv(self.upsampler[2], conv(self.upsampler[0], x,
                                                relu=True))
            up = unpad(convex_upsample(flow8, mask), pad).contiguous()
        return up[:b], up[b:], [(up[:b], up[b:]), (flow8[:b], flow8[b:])]


def init_weights(model: GMFlowNet,
                 generator: Optional[torch.Generator] = None) -> None:
    """GMFlow's initialisation, drawn from ``generator``: the backbone's
    convs' weights Kaiming-normal (fan out, ReLU) as ``backbone.py`` sets
    them; every weight of the Transformer and of the propagation with more
    than one dimension Xavier-uniform; every other weight and bias
    PyTorch's default (uniform within 1 / sqrt(fan in)); the layer norms
    1 and 0."""
    g = generator
    with torch.no_grad():
        for name, m in model.named_modules():
            if not isinstance(m, (nn.Conv2d, nn.Linear)):
                continue
            fan_in = m.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            if name.startswith("backbone."):
                fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=g)
            elif name.startswith(("transformer.", "feature_flow_attn.")):
                cout = m.weight.shape[0]
                limit = math.sqrt(6.0 / (fan_in + cout))
                m.weight.uniform_(-limit, limit, generator=g)
            else:
                m.weight.uniform_(-bound, bound, generator=g)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=g)


def load_state(model: GMFlowNet, path: str) -> None:
    """A GMFlow state dict saved with ``torch.save`` (a published
    checkpoint holds it under ``model``, and its keys may carry
    DataParallel's ``module.``), loaded strictly."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    model.load_state_dict({k[len("module."):] if k.startswith("module.")
                           else k: v for k, v in sd.items()}, strict=True)
