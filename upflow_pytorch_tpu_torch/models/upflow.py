"""The UPFlow network (bidirectional inference forward), PyTorch/CUDA.

Port of ``upflow_pytorch_tpu.models.upflow``, at fp32 or bf16
(``compute_dtype``):

- 6-level feature pyramid for both frames, coarsest-first; decoding runs
  on levels 0..output_level (=4), i.e. 1/64 .. 1/4 resolution;
- per level (SHARED estimator/context weights, per-level 1x1 skip convs):
  rate-scaled x2 flow upsample -> at levels >= 1 with
  ``if_sgu_upsample``, self-guided upsampling (SGU) of both flows -> cost
  volume -> dense flow estimator -> dilated context network; the
  residual accumulates over both heads;
- final flow to full resolution: the rate-scaled upsample, or with
  ``if_sgu_upsample`` the final SGU stage on 1/4-resolution features of
  the raw images;
- ``forward`` adds the forward-backward occlusion check.

SGU (``_sgu_pair``): per direction, masked feature-warp kernel of the
other frame's 1x1 features -> SGU dense estimator (inter-flow and mask
logit); then at the decode levels one blend launch for both directions
(``ops/warp.py::sgu_blend_pair``, which reads the raw heads in place), at
the end per direction the final-stage kernel
(``ops/kernels/sgu_final.py``), which upsamples, warps and blends in one
pass.

The cost volume per level and direction:

- level 0: torch normalisation -> correlation kernel -> LeakyReLU;
- levels >= 1: masked feature-warp kernel -> torch moments -> normalised
  correlation kernel (affine, correlation and LeakyReLU in one pass);
- with ``if_use_cor_pytorch`` every level >= 1 takes the unfused
  composition instead: masked feature-warp kernel -> torch
  normalisation -> correlation kernel -> LeakyReLU.

At bf16 the casts are the JAX package's: the images enter the pyramid and
``SGUOutputConv`` as bf16, every conv computes and returns bf16 (the
parameters stay fp32 and are rounded at each use), the cost volume is
rounded to bf16 after its LeakyReLU, the upsampled flow is rounded where
it enters the estimator and ``flow_up + res`` where it enters the context
network, and the estimator's residual, the context network's output and
the SGU head's output for the final stage come back as fp32; the blend
widens the bf16 head in its kernel.  Flows, resizes, the SGU blend and
final stage and the occlusion check stay fp32.  The feature warps keep
the bf16 maps (rounded once), the correlations read them and compute in
fp32, and the 3x3 convs of the dense stacks run ``conv3x3_seg`` where the
JAX package's predicate selects it (``ops/conv.py``).

CUDA tensors always go through the kernels; CPU tensors through their
plain versions.  Internally NCHW; ``forward`` takes and returns NHWC.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from upflow_pytorch_tpu_torch.checkpoint.convert import params_from_jax
from upflow_pytorch_tpu_torch.checkpoint.npz_io import load_npz_flat
from upflow_pytorch_tpu_torch.config import UPFlowConfig
from upflow_pytorch_tpu_torch.models.blocks import (
    ContextNetwork, ConvBlock, FeatureExtractor, FlowEstimatorDense,
    SGUModel)
from upflow_pytorch_tpu_torch.models.occlusion import occ_check
from upflow_pytorch_tpu_torch.ops import warp as _warp
from upflow_pytorch_tpu_torch.ops.correlation import correlation
from upflow_pytorch_tpu_torch.ops.kernels.corr_norm import warp_norm_corr
from upflow_pytorch_tpu_torch.ops.kernels.sgu_final import sgu_final
from upflow_pytorch_tpu_torch.ops.normalize import normalize_features
from upflow_pytorch_tpu_torch.ops.resize import (
    full_fp32_matmuls, upsample2d_flow_as)

Flows = List[Tuple[torch.Tensor, torch.Tensor]]


class UPFlowNet(nn.Module):
    """Bidirectional PWC-style pyramid flow network with optional SGU."""

    def __init__(self, conf: UPFlowConfig = UPFlowConfig(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if conf.search_range != 4:
            raise ValueError("the correlation kernels are built for "
                             "search_range 4, got %d" % conf.search_range)
        self.conf = conf
        self.dtype = (torch.bfloat16 if conf.compute_dtype == "bfloat16"
                      else torch.float32)
        g = generator
        self.feature_pyramid_extractor = FeatureExtractor(conf.num_chs, g)
        self.flow_estimators = FlowEstimatorDense(
            conf.dim_corr + 32 + 2, conf.estimator_f_channels, 2, g)
        self.context_networks = ContextNetwork(
            self.flow_estimators.feat_dim + 2, conf.context_f_channels, g)
        # per-level 1x1 skip convs: 196/128/96/64/32 -> 32
        level_chs = conf.num_chs[::-1][:conf.output_level + 1]
        self.conv_1x1 = nn.ModuleList(
            ConvBlock(c, 32, kernel_size=1, generator=g) for c in level_chs)
        if conf.if_sgu_upsample:
            self.sgi_model = SGUModel(g)

    def _sgu_pair(self, flow_1, flow_2, feature_1, feature_2,
                  output_hw=None):
        """Both directions of ``sgu_model.forward``: each flow refined by
        the SGU estimator on ``feature_*`` (the 1x1 features of the two
        frames).  With ``output_hw`` (the final stage) the result is at
        that size."""
        hw = feature_1.shape[2:]
        if flow_1.shape[2:] != hw:
            flow_1 = upsample2d_flow_as(flow_1, hw, if_rate=True)
            flow_2 = upsample2d_flow_as(flow_2, hw, if_rate=True)
        estimator = self.sgi_model.dense_estimator_mask
        heads = []
        for fl, fa, fb in ((flow_1, feature_1, feature_2),
                           (flow_2, feature_2, feature_1)):
            fb_warp = _warp.flow_warp_masked(fb, fl)
            if self.dtype == torch.bfloat16:
                x = estimator.dense_buffer([fa, fb_warp])
            else:
                x = torch.cat([fa, fb_warp], dim=1)
            heads.append(estimator(x)[1])
        if output_hw is not None:
            return tuple(sgu_final(fl, x_out.float(), output_hw)
                         for fl, x_out in zip((flow_1, flow_2), heads))
        # the raw heads, fp32 or bf16, go to one blend launch for the level
        return _warp.sgu_blend_pair(flow_1, heads[0], flow_2, heads[1])

    def _norm_kw(self) -> Optional[dict]:
        c = self.conf
        if not c.if_norm_before_cost_volume:
            return None
        return dict(normalize=True, center=True,
                    moments_across_channels=c.norm_moments_across_channels,
                    moments_across_images=c.norm_moments_across_images)

    def _cost_volumes(self, level, flow_1_up, flow_2_up, feature_1,
                      feature_2):
        """The two directions' 81-channel cost volumes, after LeakyReLU."""
        c = self.conf
        norm_kw = self._norm_kw()
        if level > 0 and not c.if_use_cor_pytorch:
            thr = _warp.mask_threshold()
            return (warp_norm_corr(feature_1, feature_2, flow_1_up, norm_kw,
                                   0.1, thr),
                    warp_norm_corr(feature_2, feature_1, flow_2_up, norm_kw,
                                   0.1, thr))
        if level == 0:
            feature_2_warp, feature_1_warp = feature_2, feature_1
        else:
            feature_2_warp = _warp.flow_warp_masked(feature_2, flow_1_up)
            feature_1_warp = _warp.flow_warp_masked(feature_1, flow_2_up)
        if norm_kw is not None:
            feature_1, feature_2_warp = normalize_features(
                (feature_1, feature_2_warp), **norm_kw)
            feature_2, feature_1_warp = normalize_features(
                (feature_2, feature_1_warp), **norm_kw)
        corrs = (correlation(feature_1.contiguous(),
                             feature_2_warp.contiguous(), c.search_range),
                 correlation(feature_2.contiguous(),
                             feature_1_warp.contiguous(), c.search_range))
        return tuple(F.leaky_relu(x, negative_slope=0.1) for x in corrs)

    def _decode_level(self, level, flow_1, flow_2, feature_1, feature_1_1x1,
                      feature_2, feature_2_1x1):
        """``decode_level_res``: returns (flow_1_up, flow_2_up, res_1,
        res_2)."""
        hw = feature_1.shape[2:]
        flow_1_up = upsample2d_flow_as(flow_1, hw, if_rate=True)
        flow_2_up = upsample2d_flow_as(flow_2, hw, if_rate=True)
        if level > 0 and self.conf.if_sgu_upsample:
            flow_1_up, flow_2_up = self._sgu_pair(
                flow_1_up, flow_2_up, feature_1_1x1, feature_2_1x1)
        corr_1, corr_2 = self._cost_volumes(level, flow_1_up, flow_2_up,
                                            feature_1, feature_2)
        out = [self._heads(corr_1, feature_1_1x1, flow_1_up),
               self._heads(corr_2, feature_2_1x1, flow_2_up)]
        return flow_1_up, flow_2_up, out[0], out[1]

    def _heads(self, corr, f_1x1, flow_up):
        """The dense flow estimator and the context network of one
        direction: the fp32 residual ``res + fine``."""
        estimator = self.flow_estimators
        if self.dtype != torch.bfloat16:
            feat, res = estimator(torch.cat([corr, f_1x1, flow_up], dim=1))
            return res + self.context_networks(
                torch.cat([feat, flow_up + res], dim=1))
        # one buffer: the estimator's features, then flow_up + res for the
        # context network in the last two channels
        buf = estimator.dense_buffer([corr, f_1x1, flow_up], extra=2)
        res = estimator(buf)[1].float()
        buf[:, estimator.feat_dim:] = flow_up + res
        return res + self.context_networks(buf).float()

    def forward(self, im1: torch.Tensor, im2: torch.Tensor):
        """``forward_2_frame_v3`` on NCHW images (B, 3, H, W).  Returns
        ``(flow_f_out, flow_b_out, flows)``; ``flows`` is the per-level
        ``[(flow_f, flow_b)]`` list FINEST-FIRST."""
        b, _, height, width = im1.shape
        x1_pyramid = self.feature_pyramid_extractor(im1.to(self.dtype))
        x2_pyramid = self.feature_pyramid_extractor(im2.to(self.dtype))
        h0, w0 = x1_pyramid[0].shape[2:]
        flow_f = im1.new_zeros((b, 2, h0, w0))
        flow_b = im1.new_zeros((b, 2, h0, w0))
        flows: Flows = []
        for level in range(self.conf.output_level + 1):
            x1, x2 = x1_pyramid[level], x2_pyramid[level]
            flow_f_up, flow_b_up, res_f, res_b = self._decode_level(
                level, flow_f, flow_b, x1, self.conv_1x1[level](x1),
                x2, self.conv_1x1[level](x2))
            flow_f = flow_f_up + res_f
            flow_b = flow_b_up + res_b
            flows.append((flow_f, flow_b))
        if self.conf.if_sgu_upsample:
            up_conv = self.sgi_model.upsample_output_conv
            flow_f_out, flow_b_out = self._sgu_pair(
                flow_f, flow_b, up_conv(im1.to(self.dtype)),
                up_conv(im2.to(self.dtype)),
                output_hw=(height, width))
        else:
            flow_f_out = upsample2d_flow_as(flow_f, (height, width),
                                            if_rate=True)
            flow_b_out = upsample2d_flow_as(flow_b, (height, width),
                                            if_rate=True)
        return flow_f_out, flow_b_out, flows[::-1]


def _resolve_device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU unless the caller "
                "passes device='cpu'")
        device = "cuda"
    return torch.device(device)


def build_model(conf: UPFlowConfig = UPFlowConfig(), device=None,
                weights: Optional[str] = None, seed: int = 0) -> UPFlowNet:
    """The network in eval mode on ``device`` (CUDA unless ``"cpu"`` is
    asked for).  Weights: Kaiming-normal from a ``torch.Generator`` seeded
    with ``seed``, or, with ``weights``, a JAX ``.npz`` snapshot (such as
    ``assets/synthetic_trained.npz``) loaded strictly through
    ``params_from_jax``; snapshot entries the model lacks (the SGU
    weights, when it is built without SGU) are listed in
    ``model.skipped_keys``."""
    device = _resolve_device(device)
    model = UPFlowNet(conf, torch.Generator().manual_seed(seed))
    model.skipped_keys = []
    if weights is not None:
        sd = params_from_jax(load_npz_flat(weights),
                             model.state_dict().keys(), model.skipped_keys)
        model.load_state_dict(sd, strict=True)
    return model.to(device).eval()


def _as_nchw(x, device: torch.device) -> torch.Tensor:
    x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
    return x.to(device=device, dtype=torch.float32).permute(0, 3, 1, 2
                                                             ).contiguous()


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def forward(model: UPFlowNet, im1, im2) -> Dict[str, Any]:
    """Inference forward (``UPFlow_net.forward`` with if_loss=False): flows
    and analytic occlusion masks.

    ``im1``, ``im2``: (B, H, W, 3) NHWC, tensors or arrays; they are moved
    to the model's device.  Returns NHWC ``flow_f_out``, ``flow_b_out``
    (B, H, W, 2), ``occ_fw``, ``occ_bw`` (B, H, W, 1) and ``flows``, the
    per-level ``[(flow_f, flow_b)]`` list finest-first, all fp32 whatever
    the compute dtype.  fp32 convolutions and matrix products (the flow
    resizes) run in full fp32: cuDNN's TF32 is switched off and the matrix
    products' precision pinned for the call, whatever the caller set
    (``ops/resize.py::full_fp32_matmuls``).
    """
    conf = model.conf
    device = next(model.parameters()).device
    cudnn = torch.backends.cudnn
    with torch.no_grad(), full_fp32_matmuls(), cudnn.flags(
            enabled=cudnn.enabled, benchmark=cudnn.benchmark,
            deterministic=cudnn.deterministic, allow_tf32=False):
        flow_f, flow_b, flows = model(_as_nchw(im1, device),
                                      _as_nchw(im2, device))
        occ_fw, occ_bw = occ_check(flow_f, flow_b, conf.alpha_1,
                                   conf.alpha_2, conf.occ_check_obj_out_all,
                                   conf.occ_type)
    return {
        "flow_f_out": _nhwc(flow_f),
        "flow_b_out": _nhwc(flow_b),
        "occ_fw": _nhwc(occ_fw),
        "occ_bw": _nhwc(occ_bw),
        "flows": [(_nhwc(f), _nhwc(b)) for f, b in flows],
    }
