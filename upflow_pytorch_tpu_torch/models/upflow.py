"""The UPFlow network (bidirectional forward and training losses),
PyTorch/CUDA.

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
- ``forward`` adds the forward-backward occlusion check;
  ``forward_with_loss`` adds the unsupervised losses of training
  (smoothness, photometric with the boundary-dilated or plain warp,
  census, multi-scale distillation).

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
plain versions.  Under autograd each kernel op goes through its
``torch.autograd.Function`` (the JAX package's gradient rule), the bf16
dense stacks concatenate instead of writing into buffers, and with
``remat`` the estimator and the context network recompute their
activations in the backward.  Internally NCHW; ``forward`` and
``forward_with_loss`` take and return NHWC.

Width sharding (the eval step over a mesh's 'spatial' axis,
``parallel/spatial.py``): ``UPFlowNet.forward`` and ``forward`` take a
``shard``, and each rank computes its columns of every map, through the
same code.  Every op that reads across columns gets the map's
``Columns``: the convs read a window of their input (a halo, a stride-2
span), the resizes the columns their taps reach, the moments sum over
every rank's own columns, the correlations run on a window of +-4
columns and are cropped, and the warps (the feature warps, the SGU blend
and final stage, the occlusion check's) gather their source and write
the rank's columns of the frame.  Every kernel stays on, and the bf16
convs take the route of the whole frame's shape.
"""

from __future__ import annotations

import contextlib
from typing import (
    TYPE_CHECKING, Any, Dict, Iterator, List, Optional, Tuple)

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from upflow_pytorch_tpu_torch.checkpoint.convert import params_from_jax
from upflow_pytorch_tpu_torch.checkpoint.npz_io import load_npz_flat
from upflow_pytorch_tpu_torch.config import UPFlowConfig
from upflow_pytorch_tpu_torch.losses.census import census_loss
from upflow_pytorch_tpu_torch.losses.photometric import photo_loss_multi_type
from upflow_pytorch_tpu_torch.losses.smoothness import (
    edge_aware_smoothness_order1, edge_aware_smoothness_order2,
    flow_smooth_delta)
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
    downsample_area, full_fp32_matmuls, upsample2d_flow_as, upsample_flow)
from upflow_pytorch_tpu_torch.utils.profiling import span

if TYPE_CHECKING:
    from upflow_pytorch_tpu_torch.parallel.spatial import WidthShard

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
                  output_hw=None, cols=None, flow_cols=None):
        """Both directions of ``sgu_model.forward``: each flow refined by
        the SGU estimator on ``feature_*`` (the 1x1 features of the two
        frames).  With ``output_hw`` (the final stage) the result is at
        that size.  On a width-sharded frame ``cols`` and ``flow_cols``
        are the features' and the flows' ``Columns``."""
        hw = _global_hw(feature_1, cols)
        if _global_hw(flow_1, flow_cols) != hw:
            flow_1 = upsample2d_flow_as(flow_1, hw, True, flow_cols)
            flow_2 = upsample2d_flow_as(flow_2, hw, True, flow_cols)
        estimator = self.sgi_model.dense_estimator_mask
        heads = []
        for fl, fa, fb in ((flow_1, feature_1, feature_2),
                           (flow_2, feature_2, feature_1)):
            fb_warp = _warp.flow_warp_masked(fb, fl, cols)
            if self.dtype == torch.bfloat16:
                x = estimator.dense_input([fa, fb_warp])
            else:
                x = torch.cat([fa, fb_warp], dim=1)
            heads.append(estimator(x, cols)[1])
        if output_hw is not None:
            if cols is None:
                return tuple(sgu_final(fl, x_out.float(), output_hw)
                             for fl, x_out in zip((flow_1, flow_2), heads))
            # the quarter-resolution flow and head whole, this rank's
            # columns of the full-resolution result
            out = cols.to(int(output_hw[1]))
            return tuple(sgu_final(cols.gather(fl), cols.gather(x_out).float(),
                                   output_hw, out.lo, out.hi - out.lo)
                         for fl, x_out in zip((flow_1, flow_2), heads))
        # the raw heads, fp32 or bf16, go to one blend launch for the level
        return _warp.sgu_blend_pair(flow_1, heads[0], flow_2, heads[1], cols)

    def _norm_kw(self) -> Optional[dict]:
        c = self.conf
        if not c.if_norm_before_cost_volume:
            return None
        return dict(normalize=True, center=True,
                    moments_across_channels=c.norm_moments_across_channels,
                    moments_across_images=c.norm_moments_across_images)

    def _cost_volumes(self, level, flow_1_up, flow_2_up, feature_1,
                      feature_2, cols=None):
        """The two directions' 81-channel cost volumes, after LeakyReLU."""
        c = self.conf
        norm_kw = self._norm_kw()
        if level > 0 and not c.if_use_cor_pytorch:
            thr = _warp.mask_threshold()
            return (warp_norm_corr(feature_1, feature_2, flow_1_up, norm_kw,
                                   0.1, thr, cols),
                    warp_norm_corr(feature_2, feature_1, flow_2_up, norm_kw,
                                   0.1, thr, cols))
        if level == 0:
            feature_2_warp, feature_1_warp = feature_2, feature_1
        else:
            feature_2_warp = _warp.flow_warp_masked(feature_2, flow_1_up,
                                                    cols)
            feature_1_warp = _warp.flow_warp_masked(feature_1, flow_2_up,
                                                    cols)
        if norm_kw is not None:
            feature_1, feature_2_warp = normalize_features(
                (feature_1, feature_2_warp), **norm_kw, cols=cols)
            feature_2, feature_1_warp = normalize_features(
                (feature_2, feature_1_warp), **norm_kw, cols=cols)
        corrs = (_correlation(feature_1, feature_2_warp, c.search_range,
                              cols),
                 _correlation(feature_2, feature_1_warp, c.search_range,
                              cols))
        return tuple(F.leaky_relu(x, negative_slope=0.1) for x in corrs)

    def _decode_level(self, level, flow_1, flow_2, feature_1, feature_1_1x1,
                      feature_2, feature_2_1x1, cols=None, flow_cols=None):
        """``decode_level_res``: returns (flow_1_up, flow_2_up, res_1,
        res_2).  On a width-sharded frame ``cols`` and ``flow_cols`` are
        the level's and the incoming flows' ``Columns``."""
        hw = _global_hw(feature_1, cols)
        flow_1_up = upsample2d_flow_as(flow_1, hw, True, flow_cols)
        flow_2_up = upsample2d_flow_as(flow_2, hw, True, flow_cols)
        if level > 0 and self.conf.if_sgu_upsample:
            flow_1_up, flow_2_up = self._sgu_pair(
                flow_1_up, flow_2_up, feature_1_1x1, feature_2_1x1,
                cols=cols, flow_cols=cols)
        corr_1, corr_2 = self._cost_volumes(level, flow_1_up, flow_2_up,
                                            feature_1, feature_2, cols)
        out = [self._heads(corr_1, feature_1_1x1, flow_1_up, cols),
               self._heads(corr_2, feature_2_1x1, flow_2_up, cols)]
        return flow_1_up, flow_2_up, out[0], out[1]

    def _remat(self, module: nn.Module, x: torch.Tensor, cols=None):
        """``module(x, cols)``; with ``remat`` under autograd its
        activations are recomputed in the backward instead of kept
        (``nn.remat`` of the JAX package's estimator and context
        network)."""
        if self.conf.remat and torch.is_grad_enabled():
            return checkpoint(module, x, cols, use_reentrant=False)
        return module(x, cols)

    def _heads(self, corr, f_1x1, flow_up, cols=None):
        """The dense flow estimator and the context network of one
        direction: the fp32 residual ``res + fine``.  ``cols``: the
        level's ``Columns`` on a width-sharded frame (an eval path: the
        training paths take whole frames)."""
        estimator = self.flow_estimators
        if self.dtype != torch.bfloat16:
            feat, res = self._remat(
                estimator, torch.cat([corr, f_1x1, flow_up], dim=1), cols)
            return res + self._remat(self.context_networks,
                                     torch.cat([feat, flow_up + res], dim=1),
                                     cols)
        if torch.is_grad_enabled():
            feat, res = self._remat(
                estimator, estimator.dense_input([corr, f_1x1, flow_up]))
            res = res.float()
            ctx_in = torch.cat([feat, (flow_up + res).to(torch.bfloat16)],
                               dim=1)
            return res + self._remat(self.context_networks, ctx_in).float()
        # one buffer: the estimator's features, then flow_up + res for the
        # context network in the last two channels
        buf = estimator.dense_buffer([corr, f_1x1, flow_up], extra=2)
        res = estimator(buf, cols)[1].float()
        buf[:, estimator.feat_dim:] = flow_up + res
        return res + self.context_networks(buf, cols).float()

    def map_widths(self, width: int) -> Dict[str, int]:
        """The pyramid's widths for a frame ``width`` columns wide,
        coarsest first, by name."""
        widths = self.feature_pyramid_extractor.level_widths(width)
        return {"pyramid level 1/%d" % 2 ** (len(widths) - i): w
                for i, w in enumerate(widths)}

    def forward(self, im1: torch.Tensor, im2: torch.Tensor,
                shard: Optional[WidthShard] = None):
        """``forward_2_frame_v3`` on NCHW images (B, 3, H, W).  Returns
        ``(flow_f_out, flow_b_out, flows)``; ``flows`` is the per-level
        ``[(flow_f, flow_b)]`` list FINEST-FIRST.

        With ``shard`` the images are the whole frames and this rank
        computes its columns ``shard.cols(w)`` of every map of width ``w``
        (``parallel/spatial.py``); the outputs are its columns of the
        flows.  A frame whose coarsest level leaves a rank no column
        raises ``ValueError``."""
        b, _, height, width = im1.shape
        cols = None
        level_cols = [None] * len(self.feature_pyramid_extractor.convs)
        if shard is not None:
            shard.check(self.map_widths(width))
            cols = shard.at(width)
            im1, im2 = im1[..., cols.lo:cols.hi], im2[..., cols.lo:cols.hi]
            level_cols = [shard.at(w) for w in
                          self.feature_pyramid_extractor.level_widths(width)]
        with span("upflow.pyramid"):
            x1_pyramid = self.feature_pyramid_extractor(im1.to(self.dtype),
                                                        cols)
            x2_pyramid = self.feature_pyramid_extractor(im2.to(self.dtype),
                                                        cols)
        h0, w0 = x1_pyramid[0].shape[2:]
        flow_f = im1.new_zeros((b, 2, h0, w0))
        flow_b = im1.new_zeros((b, 2, h0, w0))
        flow_cols = level_cols[0]
        flows: Flows = []
        for level in range(self.conf.output_level + 1):
            with span("upflow.level.", level):
                x1, x2 = x1_pyramid[level], x2_pyramid[level]
                lc = level_cols[level]
                flow_f_up, flow_b_up, res_f, res_b = self._decode_level(
                    level, flow_f, flow_b, x1,
                    self.conv_1x1[level](x1, cols=lc), x2,
                    self.conv_1x1[level](x2, cols=lc), lc, flow_cols)
                flow_f = flow_f_up + res_f
                flow_b = flow_b_up + res_b
            flow_cols = lc
            flows.append((flow_f, flow_b))
        with span("upflow.upsample"):
            if self.conf.if_sgu_upsample:
                up_conv = self.sgi_model.upsample_output_conv
                flow_f_out, flow_b_out = self._sgu_pair(
                    flow_f, flow_b, up_conv(im1.to(self.dtype), cols),
                    up_conv(im2.to(self.dtype), cols),
                    output_hw=(height, width), cols=up_conv.out_cols(cols),
                    flow_cols=flow_cols)
            else:
                flow_f_out = upsample2d_flow_as(flow_f, (height, width),
                                                True, flow_cols)
                flow_b_out = upsample2d_flow_as(flow_b, (height, width),
                                                True, flow_cols)
        return flow_f_out, flow_b_out, flows[::-1]


def _global_hw(x: torch.Tensor, cols) -> Tuple[int, int]:
    """(H, W) of the map ``x``, or of the width-sharded map whose columns
    ``cols`` it holds."""
    return (x.shape[2], x.shape[3] if cols is None else cols.width)


def _correlation(f1: torch.Tensor, f2: torch.Tensor, d: int,
                 cols=None) -> torch.Tensor:
    """The cost volume of ``f1`` against ``f2``.  On a width-sharded frame
    (``cols``) it runs on this rank's columns widened by ``d`` each side,
    zero outside the frame (the correlation's own padding), and is
    cropped to them: ``f1``'s extra columns are zeros, as they reach only
    the cropped outputs, and ``f2``'s come from the neighbours.  The
    kernel takes the grid of the frame's width."""
    if cols is None:
        return correlation(f1.contiguous(), f2.contiguous(), d)
    f1 = F.pad(f1, (d, d))
    f2 = cols.halo(f2, d, d)
    out = correlation(f1.contiguous(), f2.contiguous(), d, cols.width)
    return out[..., d:out.shape[3] - d]


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


@contextlib.contextmanager
def fp32_numerics() -> Iterator[None]:
    """fp32 convolutions and matrix products (the flow resizes) in full
    fp32 for the block: cuDNN's TF32 switched off and the matrix products'
    precision pinned (``ops/resize.py::full_fp32_matmuls``), whatever the
    caller set, and both restored after it."""
    cudnn = torch.backends.cudnn
    with full_fp32_matmuls(), cudnn.flags(
            enabled=cudnn.enabled, benchmark=cudnn.benchmark,
            deterministic=cudnn.deterministic, allow_tf32=False):
        yield


def forward(model: UPFlowNet, im1, im2,
            shard: Optional[WidthShard] = None) -> Dict[str, Any]:
    """Inference forward (``UPFlow_net.forward`` with if_loss=False): flows
    and analytic occlusion masks.

    ``im1``, ``im2``: (B, H, W, 3) NHWC, tensors or arrays; they are moved
    to the model's device.  Returns NHWC ``flow_f_out``, ``flow_b_out``
    (B, H, W, 2), ``occ_fw``, ``occ_bw`` (B, H, W, 1) and ``flows``, the
    per-level ``[(flow_f, flow_b)]`` list finest-first, all fp32 whatever
    the compute dtype.  Runs under ``fp32_numerics``.  With ``shard``
    (``parallel/spatial.py::WidthShard``) every output is this rank's
    columns ``shard.cols(w)`` of its width ``w`` (``UPFlowNet.forward``).
    """
    with span("upflow.forward"):
        conf = model.conf
        device = next(model.parameters()).device
        with span("upflow.copy_in"):
            im1, im2 = _as_nchw(im1, device), _as_nchw(im2, device)
        cols = None if shard is None else shard.at(im1.shape[3])
        with torch.no_grad(), fp32_numerics():
            flow_f, flow_b, flows = model(im1, im2, shard)
            with span("upflow.occlusion"):
                occ_fw, occ_bw = occ_check(
                    flow_f, flow_b, conf.alpha_1, conf.alpha_2,
                    conf.occ_check_obj_out_all, conf.occ_type, cols=cols)
        with span("upflow.copy_out"):
            return {
                "flow_f_out": _nhwc(flow_f),
                "flow_b_out": _nhwc(flow_b),
                "occ_fw": _nhwc(occ_fw),
                "occ_bw": _nhwc(occ_bw),
                "flows": [(_nhwc(f), _nhwc(b)) for f, b in flows],
            }


def _smooth_loss(conf: UPFlowConfig, ims, flows) -> torch.Tensor:
    """The smoothness terms of both directions: edge-aware or delta, of
    order 1 and 2, each weighted."""
    (im1, im2), (flow_f, flow_b) = ims, flows
    loss = flow_f.new_zeros(())
    for order, weight in ((1, conf.smooth_order_1_weight),
                          (2, conf.smooth_order_2_weight)):
        if weight <= 0:
            continue
        if conf.smooth_type == "edge":
            fn = (edge_aware_smoothness_order1 if order == 1
                  else edge_aware_smoothness_order2)
            loss = loss + weight * (fn(im1, flow_f) + fn(im2, flow_b))
        elif conf.smooth_type == "delta":
            loss = loss + weight * (flow_smooth_delta(flow_f, order == 2)
                                    + flow_smooth_delta(flow_b, order == 2))
        else:
            raise ValueError("wrong smooth_type: %s" % conf.smooth_type)
    return loss


def _msd_loss(conf: UPFlowConfig, flows: Flows, flow_f, flow_b, occ_fw,
              occ_bw) -> torch.Tensor:
    """The multi-scale distillation: each level's flows against the final
    flows (detached), 'down' at the level's size or 'upup' at the final
    size."""
    label_f, label_b = flow_f.detach(), flow_b.detach()
    msd = flow_f.new_zeros(())
    for scale_f, scale_b in flows:
        if conf.multi_scale_distillation_style == "down":
            hw = scale_f.shape[2:]
            pairs = ((scale_f, upsample_flow(label_f, hw),
                      _nearest_resize(occ_fw, hw)),
                     (scale_b, upsample_flow(label_b, hw),
                      _nearest_resize(occ_bw, hw)))
        elif conf.multi_scale_distillation_style == "upup":
            hw = label_f.shape[2:]
            pairs = ((upsample_flow(scale_f, hw), label_f, occ_fw),
                     (upsample_flow(scale_b, hw), label_b, occ_bw))
        else:
            raise ValueError("wrong multi_scale_distillation_style: %s"
                             % conf.multi_scale_distillation_style)
        for pred, label, occ in pairs:
            msd = msd + photo_loss_multi_type(
                pred, label, occ, "abs_robust",
                photo_loss_use_occ=conf.multi_scale_distillation_occ)
    return conf.multi_scale_distillation_weight * msd


def forward_with_loss(model: UPFlowNet, batch: Dict[str, Any]
                      ) -> Dict[str, Any]:
    """Training forward and the unsupervised losses (``UPFlow_net.forward``
    with if_loss=True).

    ``batch``: NHWC ``im1``, ``im2`` (the crops), and as the knobs need
    them ``im1_raw``, ``im2_raw`` and ``start`` (B, 2) in (x, y) order for
    the boundary-dilated warp, ``im1_sp``, ``im2_sp`` for
    ``input_or_sp_input``; tensors or arrays, moved to the model's device.
    Returns the forward's NHWC outputs (as ``forward``), ``im1_warp``,
    ``im2_warp`` (NHWC) and the scalar ``smooth_loss``, ``photo_loss``,
    ``census_loss`` and ``msd_loss`` (None when their weight is 0) and
    ``total_loss``, differentiable with respect to the parameters when
    grad mode is on.  Runs under ``fp32_numerics``; a backward of
    ``total_loss`` must too (``train/step.py`` does it).
    """
    conf = model.conf
    device = next(model.parameters()).device
    im1_ori = _as_nchw(batch["im1"], device)
    im2_ori = _as_nchw(batch["im2"], device)
    if conf.input_or_sp_input == 1:
        im1, im2 = im1_ori, im2_ori
    else:
        im1 = _as_nchw(batch["im1_sp"], device)
        im2 = _as_nchw(batch["im2_sp"], device)
    with fp32_numerics():
        flow_f, flow_b, flows = model(im1, im2)
        # thresholds of the flows: their gradient is zero everywhere
        with torch.no_grad():
            occ_fw, occ_bw = occ_check(
                flow_f, flow_b, conf.alpha_1, conf.alpha_2,
                conf.occ_check_obj_out_all, conf.occ_type)

        if conf.smooth_level == "final":
            s_flows, s_ims = (flow_f, flow_b), (im1_ori, im2_ori)
        elif conf.smooth_level == "1/4":
            s_flows = flows[0]
            hw = s_flows[0].shape[2:]
            s_ims = (downsample_area(im1_ori, hw),
                     downsample_area(im2_ori, hw))
        else:
            raise ValueError("wrong smooth level: %s" % conf.smooth_level)
        smooth_loss = _smooth_loss(conf, s_ims, s_flows)

        if conf.if_use_boundary_warp:
            start = torch.as_tensor(batch["start"]).to(device)
            im1_warp = _warp.boundary_dilated_warp(
                _as_nchw(batch["im2_raw"], device), flow_f, start)
            im2_warp = _warp.boundary_dilated_warp(
                _as_nchw(batch["im1_raw"], device), flow_b, start)
        else:
            im1_warp = _warp.flow_warp(im2_ori, flow_f)
            im2_warp = _warp.flow_warp(im1_ori, flow_b)
        occ_fw_l, occ_bw_l = occ_fw, occ_bw
        if conf.stop_occ_gradient:
            occ_fw_l, occ_bw_l = occ_fw_l.detach(), occ_bw_l.detach()
        photo_loss = sum(photo_loss_multi_type(
            im, warped, occ, conf.photo_loss_type, conf.photo_loss_delta,
            conf.photo_loss_use_occ)
            for im, warped, occ in ((im1_ori, im1_warp, occ_fw_l),
                                    (im2_ori, im2_warp, occ_bw_l)))

        census = None
        if conf.photo_loss_census_weight > 0:
            census = conf.photo_loss_census_weight * sum(census_loss(
                im, warped, occ, q=conf.photo_loss_delta,
                charbonnier_or_abs_robust=False,
                if_use_occ=conf.photo_loss_use_occ)
                for im, warped, occ in ((im1_ori, im1_warp, occ_fw_l),
                                        (im2_ori, im2_warp, occ_bw_l)))
        msd_loss = None
        if conf.multi_scale_distillation_weight > 0:
            msd_loss = _msd_loss(conf, flows, flow_f, flow_b, occ_fw, occ_bw)

        total = photo_loss + smooth_loss
        if census is not None:
            total = total + census
        if msd_loss is not None:
            total = total + msd_loss
    return {
        "flow_f_out": _nhwc(flow_f),
        "flow_b_out": _nhwc(flow_b),
        "occ_fw": _nhwc(occ_fw),
        "occ_bw": _nhwc(occ_bw),
        "flows": [(_nhwc(f), _nhwc(b)) for f, b in flows],
        "im1_warp": _nhwc(im1_warp),
        "im2_warp": _nhwc(im2_warp),
        "smooth_loss": smooth_loss,
        "photo_loss": photo_loss,
        "census_loss": census,
        "msd_loss": msd_loss,
        "total_loss": total,
    }


def _nearest_resize(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Nearest resize as ``F.interpolate(mode='nearest')``: source index
    ``floor(dst * in / out)``, in fp32 as the JAX package computes it."""
    _, _, h, w = x.shape
    oh, ow = int(out_hw[0]), int(out_hw[1])
    iy = torch.floor(torch.arange(oh, dtype=torch.float32, device=x.device)
                     * (h / oh)).long()
    ix = torch.floor(torch.arange(ow, dtype=torch.float32, device=x.device)
                     * (w / ow)).long()
    return x[:, :, iy][:, :, :, ix]
