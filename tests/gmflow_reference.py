"""GMFlow's forward in plain fp32 PyTorch: the reference the port's GMFlow
(``upflow_pytorch_tpu_torch/models/gmflow.py``) is held to.

haofeixu/gmflow (Xu et al., CVPR 2022) ``gmflow/gmflow.py``,
``backbone.py``, ``transformer.py``, ``matching.py``, ``position.py`` and
``utils.py``, the model of the ``gmflow_kitti`` checkpoint (one scale,
``attn_splits_list [2]``, ``corr_radius_list [-1]``, ``prop_radius_list
[-1]``, ``pred_bidir_flow``), written as functions of a flat parameter
dict keyed by GMFlow's own module names (a state dict), NCHW.  It imports
neither JAX nor the port; the port's fp32 state dict is its weights.
Callers switch TF32 off (``raft_reference.fp32``).  Each stage is a
function of its own, so that the tests hold the port to it stage by
stage: ``backbone``, ``feature_add_position``, ``transformer_layer``,
``global_correlation_softmax``, ``feature_flow_attention``,
``upsample_flow`` and the whole ``gmflow``.

Departures from ``gmflow/*.py``, none of which changes a value: the
images padded here (``InputPadder``, 'kitti' mode, ``padding_factor``
16) and the flows cropped back; the eval path only (no intermediate
flows); the shifted windows' mask built on the features' device.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

SPLITS = 2  # attn_splits_list [2]
PADDING_FACTOR = 16
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def conv(p: Params, name: str, x: torch.Tensor, stride: int = 1,
         padding: int = 0) -> torch.Tensor:
    return F.conv2d(x, p[name + ".weight"], p.get(name + ".bias"), stride,
                    padding)


def linear(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, p[name + ".weight"], p.get(name + ".bias"))


def instance_norm(x: torch.Tensor) -> torch.Tensor:
    return F.instance_norm(x, eps=1e-5)


# --- backbone.py -------------------------------------------------------------

def residual_block(p: Params, name: str, x: torch.Tensor,
                   stride: int) -> torch.Tensor:
    y = F.relu(instance_norm(conv(p, name + ".conv1", x, stride, 1)))
    y = F.relu(instance_norm(conv(p, name + ".conv2", y, 1, 1)))
    if name + ".downsample.0.weight" in p:
        x = instance_norm(conv(p, name + ".downsample.0", x, stride))
    return F.relu(x + y)


def backbone(p: Params, x: torch.Tensor) -> torch.Tensor:
    """``CNNEncoder`` with one output scale: 1/8 resolution."""
    x = F.relu(instance_norm(conv(p, "backbone.conv1", x, 2, 3)))
    for layer, stride in ((1, 1), (2, 2), (3, 2)):
        x = residual_block(p, "backbone.layer%d.0" % layer, x, stride)
        x = residual_block(p, "backbone.layer%d.1" % layer, x, 1)
    return conv(p, "backbone.conv2", x)


# --- position.py and utils.py ------------------------------------------------

def position_embedding_sine(x: torch.Tensor, num_pos_feats: int
                            ) -> torch.Tensor:
    """``PositionEmbeddingSine(num_pos_feats)`` (normalised, temperature
    1e4, scale 2 pi) of ``x`` (B, C, H, W)."""
    b, _, h, w = x.size()
    mask = torch.ones((b, h, w), device=x.device)
    y_embed = mask.cumsum(1, dtype=torch.float32)
    x_embed = mask.cumsum(2, dtype=torch.float32)
    eps, scale = 1e-6, 2 * math.pi
    y_embed = y_embed / (y_embed[:, -1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, :, -1:] + eps) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=x.device)
    dim_t = 10000 ** (2 * (dim_t // 2) / num_pos_feats)
    pos_x = x_embed[:, :, :, None] / dim_t
    pos_y = y_embed[:, :, :, None] / dim_t
    pos_x = torch.stack((pos_x[:, :, :, 0::2].sin(),
                         pos_x[:, :, :, 1::2].cos()), dim=4).flatten(3)
    pos_y = torch.stack((pos_y[:, :, :, 0::2].sin(),
                         pos_y[:, :, :, 1::2].cos()), dim=4).flatten(3)
    return torch.cat((pos_y, pos_x), dim=3).permute(0, 3, 1, 2)


def split_feature(feature: torch.Tensor, num_splits: int,
                  channel_last: bool = False) -> torch.Tensor:
    if channel_last:  # [B, H, W, C]
        b, h, w, c = feature.size()
        return feature.view(b, num_splits, h // num_splits, num_splits,
                            w // num_splits, c).permute(
            0, 1, 3, 2, 4, 5).reshape(b * num_splits * num_splits,
                                      h // num_splits, w // num_splits, c)
    b, c, h, w = feature.size()
    return feature.view(b, c, num_splits, h // num_splits, num_splits,
                        w // num_splits).permute(0, 2, 4, 1, 3, 5).reshape(
        b * num_splits * num_splits, c, h // num_splits, w // num_splits)


def merge_splits(splits: torch.Tensor, num_splits: int,
                 channel_last: bool = False) -> torch.Tensor:
    if channel_last:  # [B*K*K, H/K, W/K, C]
        b, h, w, c = splits.size()
        new_b = b // num_splits // num_splits
        splits = splits.view(new_b, num_splits, num_splits, h, w, c)
        return splits.permute(0, 1, 3, 2, 4, 5).contiguous().view(
            new_b, num_splits * h, num_splits * w, c)
    b, c, h, w = splits.size()
    new_b = b // num_splits // num_splits
    splits = splits.view(new_b, num_splits, num_splits, c, h, w)
    return splits.permute(0, 3, 1, 4, 2, 5).contiguous().view(
        new_b, c, num_splits * h, num_splits * w)


def feature_add_position(feature0: torch.Tensor, feature1: torch.Tensor,
                         attn_splits: int, feature_channels: int):
    f0 = split_feature(feature0, attn_splits)
    f1 = split_feature(feature1, attn_splits)
    position = position_embedding_sine(f0, feature_channels // 2)
    return (merge_splits(f0 + position, attn_splits),
            merge_splits(f1 + position, attn_splits))


# --- transformer.py ----------------------------------------------------------

def generate_shift_window_attn_mask(input_resolution, window_size_h,
                                    window_size_w, shift_size_h,
                                    shift_size_w, device) -> torch.Tensor:
    h, w = input_resolution
    img_mask = torch.zeros((1, h, w, 1)).to(device)
    h_slices = (slice(0, -window_size_h),
                slice(-window_size_h, -shift_size_h),
                slice(-shift_size_h, None))
    w_slices = (slice(0, -window_size_w),
                slice(-window_size_w, -shift_size_w),
                slice(-shift_size_w, None))
    cnt = 0
    for hs in h_slices:
        for ws in w_slices:
            img_mask[:, hs, ws, :] = cnt
            cnt += 1
    mask_windows = split_feature(img_mask, input_resolution[-1]
                                 // window_size_w, channel_last=True)
    mask_windows = mask_windows.view(-1, window_size_h * window_size_w)
    attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return attn_mask.masked_fill(attn_mask != 0, float(-100.0)).masked_fill(
        attn_mask == 0, float(0.0))


def single_head_split_window_attention(q, k, v, num_splits, with_shift,
                                       h, w, attn_mask):
    b, _, c = q.size()
    b_new = b * num_splits * num_splits
    window_size_h, window_size_w = h // num_splits, w // num_splits
    q, k, v = q.view(b, h, w, c), k.view(b, h, w, c), v.view(b, h, w, c)
    scale_factor = c ** 0.5
    if with_shift:
        shift_size_h, shift_size_w = window_size_h // 2, window_size_w // 2
        q = torch.roll(q, shifts=(-shift_size_h, -shift_size_w), dims=(1, 2))
        k = torch.roll(k, shifts=(-shift_size_h, -shift_size_w), dims=(1, 2))
        v = torch.roll(v, shifts=(-shift_size_h, -shift_size_w), dims=(1, 2))
    q = split_feature(q, num_splits, channel_last=True)
    k = split_feature(k, num_splits, channel_last=True)
    v = split_feature(v, num_splits, channel_last=True)
    scores = torch.matmul(q.view(b_new, -1, c),
                          k.view(b_new, -1, c).permute(0, 2, 1)
                          ) / scale_factor
    if with_shift:
        scores += attn_mask.repeat(b, 1, 1)
    attn = torch.softmax(scores, dim=-1)
    out = torch.matmul(attn, v.view(b_new, -1, c))
    out = merge_splits(out.view(b_new, h // num_splits, w // num_splits, c),
                       num_splits, channel_last=True)
    if with_shift:
        out = torch.roll(out, shifts=(shift_size_h, shift_size_w),
                         dims=(1, 2))
    return out.view(b, -1, c)


def transformer_layer(p: Params, name: str, source, target, h, w,
                      attn_mask, with_shift: bool, no_ffn: bool):
    query = linear(p, name + ".q_proj", source)
    key = linear(p, name + ".k_proj", target)
    value = linear(p, name + ".v_proj", target)
    message = single_head_split_window_attention(
        query, key, value, SPLITS, with_shift, h, w, attn_mask)
    message = linear(p, name + ".merge", message)
    c = message.shape[-1]
    message = F.layer_norm(message, (c,), p[name + ".norm1.weight"],
                           p[name + ".norm1.bias"], 1e-5)
    if not no_ffn:
        message = linear(p, name + ".mlp.2", F.gelu(linear(
            p, name + ".mlp.0", torch.cat([source, message], dim=-1))))
        message = F.layer_norm(message, (c,), p[name + ".norm2.weight"],
                               p[name + ".norm2.bias"], 1e-5)
    return source + message


def feature_transformer(p: Params, feature0: torch.Tensor,
                        feature1: torch.Tensor, layers: int):
    b, c, h, w = feature0.shape
    feature0 = feature0.flatten(-2).permute(0, 2, 1)
    feature1 = feature1.flatten(-2).permute(0, 2, 1)
    window_size_h, window_size_w = h // SPLITS, w // SPLITS
    attn_mask = generate_shift_window_attn_mask(
        (h, w), window_size_h, window_size_w, window_size_h // 2,
        window_size_w // 2, feature0.device)
    concat0 = torch.cat((feature0, feature1), dim=0)
    concat1 = torch.cat((feature1, feature0), dim=0)
    for i in range(layers):
        name, with_shift = "transformer.layers.%d" % i, i % 2 == 1
        source = transformer_layer(p, name + ".self_attn", concat0, concat0,
                                   h, w, attn_mask, with_shift, True)
        concat0 = transformer_layer(p, name + ".cross_attn_ffn", source,
                                    concat1, h, w, attn_mask, with_shift,
                                    False)
        concat1 = torch.cat(concat0.chunk(chunks=2, dim=0)[::-1], dim=0)
    feature0, feature1 = concat0.chunk(chunks=2, dim=0)
    feature0 = feature0.view(b, h, w, c).permute(0, 3, 1, 2).contiguous()
    feature1 = feature1.view(b, h, w, c).permute(0, 3, 1, 2).contiguous()
    return feature0, feature1


# --- matching.py and gmflow.py -----------------------------------------------

def coords_grid(b: int, h: int, w: int, device) -> torch.Tensor:
    y, x = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    grid = torch.stack([x, y], dim=0).float()
    return grid[None].repeat(b, 1, 1, 1).to(device)


def global_correlation_softmax(feature0: torch.Tensor,
                               feature1: torch.Tensor) -> torch.Tensor:
    """With ``pred_bidir_flow``: the forward flows, then the backward
    ones."""
    b, c, h, w = feature0.shape
    feature0 = feature0.view(b, c, -1).permute(0, 2, 1)
    feature1 = feature1.view(b, c, -1)
    correlation = torch.matmul(feature0, feature1).view(b, h, w, h, w) / (
        c ** 0.5)
    init_grid = coords_grid(b, h, w, correlation.device)
    grid = init_grid.view(b, 2, -1).permute(0, 2, 1)
    correlation = correlation.view(b, h * w, h * w)
    correlation = torch.cat((correlation, correlation.permute(0, 2, 1)),
                            dim=0)
    init_grid = init_grid.repeat(2, 1, 1, 1)
    grid = grid.repeat(2, 1, 1)
    prob = F.softmax(correlation, dim=-1)
    correspondence = torch.matmul(prob, grid).view(
        2 * b, h, w, 2).permute(0, 3, 1, 2)
    return correspondence - init_grid


def feature_flow_attention(p: Params, feature0: torch.Tensor,
                           flow: torch.Tensor) -> torch.Tensor:
    """``FeatureFlowAttention`` (global): the key projected from the
    projected query, as published."""
    b, c, h, w = feature0.size()
    query = feature0.view(b, c, h * w).permute(0, 2, 1)
    query = linear(p, "feature_flow_attn.q_proj", query)
    key = linear(p, "feature_flow_attn.k_proj", query)
    value = flow.view(b, flow.size(1), h * w).permute(0, 2, 1)
    scores = torch.matmul(query, key.permute(0, 2, 1)) / (c ** 0.5)
    prob = torch.softmax(scores, dim=-1)
    out = torch.matmul(prob, value)
    return out.view(b, h, w, value.size(-1)).permute(0, 3, 1, 2)


def upsample_flow(p: Params, flow: torch.Tensor, feature: torch.Tensor,
                  factor: int) -> torch.Tensor:
    """``GMFlow.upsample_flow``, convex."""
    concat = torch.cat((flow, feature), dim=1)
    mask = conv(p, "upsampler.2", F.relu(conv(p, "upsampler.0", concat,
                                              1, 1)))
    b, flow_channel, h, w = flow.shape
    mask = mask.view(b, 1, 9, factor, factor, h, w)
    mask = torch.softmax(mask, dim=2)
    up_flow = F.unfold(factor * flow, [3, 3], padding=1)
    up_flow = up_flow.view(b, flow_channel, 9, 1, 1, h, w)
    up_flow = torch.sum(mask * up_flow, dim=2)
    up_flow = up_flow.permute(0, 1, 4, 2, 5, 3)
    return up_flow.reshape(b, flow_channel, factor * h, factor * w)


def pad_amounts(h: int, w: int) -> list:
    """``InputPadder(mode='kitti', padding_factor=16)``'s [left, right,
    top, bottom]."""
    f = PADDING_FACTOR
    pad_ht = (((h // f) + 1) * f - h) % f
    pad_wd = (((w // f) + 1) * f - w) % f
    return [pad_wd // 2, pad_wd - pad_wd // 2, 0, pad_ht]


def gmflow(p: Params, image1: torch.Tensor, image2: torch.Tensor,
           widths: Mapping[str, Any]):
    """GMFlow(image1, image2, pred_bidir_flow=True) in eval mode on NCHW
    images in [0, 255]: (the 1/8 flows of the padded frame, the upsampled
    flows cropped to the frame), the forward then the backward ones."""
    ht, wd = image1.shape[-2:]
    pad = pad_amounts(ht, wd)
    image1 = F.pad(image1, pad, mode="replicate")
    image2 = F.pad(image2, pad, mode="replicate")
    mean = torch.tensor(MEAN, device=image1.device).view(1, 3, 1, 1)
    std = torch.tensor(STD, device=image1.device).view(1, 3, 1, 1)
    image1, image2 = (image1 / 255. - mean) / std, (image2 / 255. - mean) / std
    features = backbone(p, torch.cat((image1, image2), dim=0))
    feature0, feature1 = torch.chunk(features, 2, 0)
    c = widths["feature_channels"]
    feature0, feature1 = feature_add_position(feature0, feature1, SPLITS, c)
    feature0, feature1 = feature_transformer(
        p, feature0, feature1, widths["num_transformer_layers"])
    flow = global_correlation_softmax(feature0, feature1)
    feature0 = torch.cat((feature0, feature1), dim=0)
    flow = feature_flow_attention(p, feature0, flow)
    up = upsample_flow(p, flow, feature0, widths["upsample_factor"])
    h8, w8 = up.shape[-2:]
    return flow, up[..., pad[2]:h8 - pad[3], pad[0]:w8 - pad[1]]
