"""Spatial-transform equivariance (ARFlow-style teacher/student) loss, NCHW.

Port of ``upflow_pytorch_tpu/losses/equivariance.py``, the working form of
the reference's ex_runner equivariance pass:

1. draw a random affine (zoom, squeeze, rotation, translation, hflip) per
   batch item;
2. transform the input pair by inverse-warp sampling, I'(p) = I(A p + b);
3. transform the (detached) teacher flow as a vector field,
   f'(p) = A_lin^{-1} f(A p + b);
4. penalise the student flow of the transformed pair against the
   transformed teacher flow, over the pixels whose sample stays inside the
   frame (and, optionally, that the teacher finds unoccluded).

The samples are ``ops/warp.py::bilinear_sample`` and ``_analytic_wsum``,
the counterparts of the JAX package's ``_bilinear_zero_pad``: torch ops on
every device, as in JAX they are XLA and no kernel.  The coordinates are
computed in the JAX package's order of operations (centre, ``lin @ (x,
y)``, ``+ c``, ``+ t * (w, h)``), so the in-frame mask's ``wsum >= 1.0``,
which flips on the last bit, gives JAX's bits.

The draws come from a ``torch.Generator`` on the CPU: the same on the CPU
and on the card, and not those of ``jax.random``.  A rank of the sharded
step draws the transforms of the whole global batch and keeps its own
rows (``mesh.rows``), so N ranks draw what one process draws; the loss's
normaliser is summed over the ranks there (``parallel/reduce.py``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from upflow_pytorch_tpu_torch.models.upflow import UPFlowNet
from upflow_pytorch_tpu_torch.ops.resize import fp32_numerics
from upflow_pytorch_tpu_torch.ops.warp import _analytic_wsum, bilinear_sample
from upflow_pytorch_tpu_torch.parallel.mesh import Mesh
from upflow_pytorch_tpu_torch.parallel.reduce import global_sum, rank_share
from upflow_pytorch_tpu_torch.utils.misc import as_nchw

# the step's draws: random_affine(step_generator(step), B)
EQ_SEED = 17


class AffineParams(NamedTuple):
    """Per-item 2x2 linear part and translation (fractions of the frame,
    centred frame)."""

    lin: torch.Tensor  # (B, 2, 2)
    trans: torch.Tensor  # (B, 2)


def step_generator(step: int) -> torch.Generator:
    """The CPU generator of a training step's affine draw, seeded from
    ``(EQ_SEED, step)``: a resumed run draws the same transforms."""
    seed = np.random.SeedSequence((EQ_SEED, int(step))).generate_state(1)[0]
    return torch.Generator().manual_seed(int(seed))


def random_affine(generator: torch.Generator, batch: int,
                  zoom: Tuple[float, float] = (1.0, 1.5),
                  squeeze: Tuple[float, float] = (0.86, 1.16),
                  rotate_deg: float = 10.0, trans_frac: float = 0.1,
                  hflip_prob: float = 0.5,
                  rows: slice = slice(None)) -> AffineParams:
    """Samples the transforms of ``batch`` items (the ARFlow ranges of the
    reference's sp_config) on the CPU, fp32, and returns those of
    ``rows``."""

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=generator)

    z = uniform((batch,), *zoom)
    s = uniform((batch,), *squeeze)
    th = uniform((batch,), -rotate_deg, rotate_deg) * (math.pi / 180.0)
    t = uniform((batch, 2), -trans_frac, trans_frac)
    flip = torch.where(torch.rand((batch,), generator=generator)
                       < hflip_prob, -1.0, 1.0)
    cos, sin = torch.cos(th), torch.sin(th)
    # A = R(th) @ diag(flip * z*s, z/s); sampling takes the inverse zoom,
    # so zoom > 1 magnifies (samples a smaller source window)
    sx = flip / (z * s)
    sy = 1.0 / (z / s)
    lin = torch.stack([torch.stack([cos * sx, -sin * sy], dim=-1),
                       torch.stack([sin * sx, cos * sy], dim=-1)], dim=-2)
    return AffineParams(lin=lin[rows], trans=t[rows])


def _affine_coords(params: AffineParams, b: int, h: int, w: int,
                   device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Absolute source coords (px, py), each (B, H, W), of every output
    pixel."""
    lin = params.lin.to(device=device, dtype=torch.float32)
    trans = params.trans.to(device=device, dtype=torch.float32)
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, None, :]
    ys = torch.arange(h, dtype=torch.float32, device=device)[None, :, None]
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    xc = (xs - cx).expand(b, h, w)
    yc = (ys - cy).expand(b, h, w)
    tx = trans[:, 0, None, None] * w
    ty = trans[:, 1, None, None] * h

    def lin_row(i):
        # lin[i,0]*xc + lin[i,1]*yc with the first product fused into the
        # sum (one rounding), as XLA's fused kernel computes it: the
        # product is exact in fp64, so the fp64 sum rounded to fp32 is the
        # fused multiply-add's value
        return (lin[:, i, 0, None, None].double() * xc.double()
                + (lin[:, i, 1, None, None] * yc).double()).float()

    return lin_row(0) + cx + tx, lin_row(1) + cy + ty


def transform_image(img: torch.Tensor, params: AffineParams
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """I'(p) = I(A p + b) for ``img`` (B, C, H, W); returns the image and
    its in-frame mask (B, 1, H, W)."""
    b, _, h, w = img.shape
    px, py = _affine_coords(params, b, h, w, img.device)
    out = bilinear_sample(img, px, py)
    mask = (_analytic_wsum(h, w, px, py) >= 1.0).float()[:, None]
    return out.to(img.dtype) * mask, mask


def transform_flow(flow: torch.Tensor, params: AffineParams) -> torch.Tensor:
    """f'(p) = A_lin^{-1} f(A p + b) for ``flow`` (B, 2, H, W)."""
    b, _, h, w = flow.shape
    px, py = _affine_coords(params, b, h, w, flow.device)
    sampled = bilinear_sample(flow, px, py)
    lin = params.lin.to(device=flow.device, dtype=torch.float32)
    a, c = lin[:, 0, 0, None, None], lin[:, 0, 1, None, None]
    d, e = lin[:, 1, 0, None, None], lin[:, 1, 1, None, None]
    det = a * e - c * d
    # the 2x2 inverse in closed form (JAX's LU inverse differs by ulps)
    i00, i01, i10, i11 = e / det, -c / det, -d / det, a / det
    u, v = sampled[:, 0], sampled[:, 1]
    return torch.stack([i00 * u + i01 * v, i10 * u + i11 * v], dim=1)


def equivariance_loss(student_flow: torch.Tensor, teacher_flow: torch.Tensor,
                      valid_mask: torch.Tensor, occ_mask=None,
                      delta: float = 0.4,
                      loss_type: str = "abs_robust") -> torch.Tensor:
    """Distance between the student flow and the transformed teacher flow
    (B, 2, H, W), averaged over the valid (and, with ``occ_mask``,
    unoccluded) pixels of the masks (B, 1, H, W).

    ``loss_type='L1'`` is the reference recipe's masked L1; ``'abs_robust'``
    (default) the robust penalty of the photometric and distillation
    losses, less dominated by outliers early in training."""
    mask = valid_mask
    if occ_mask is not None:
        mask = mask * occ_mask
    err = torch.abs(student_flow - teacher_flow.detach())
    if loss_type == "abs_robust":
        diff = (err + 0.01) ** delta
    elif loss_type == "L1":
        diff = err
    else:
        raise ValueError("wrong equivariance loss_type: %s" % loss_type)
    return (rank_share(torch.sum(diff * mask))
            / (global_sum(torch.sum(mask)) * 2 + 1e-6))


def equivariance_pass(model: UPFlowNet, batch: Dict[str, Any],
                      teacher_out: Dict[str, torch.Tensor],
                      generator: torch.Generator, use_occ: bool = True,
                      loss_type: str = "abs_robust",
                      mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The whole pass: draw the transforms, transform the pair and the
    teacher's flows (``forward_with_loss``'s NHWC ``flow_f_out``,
    ``flow_b_out``, ``occ_fw``, ``occ_bw``, detached here), run the
    student forward on the transformed pair under ``fp32_numerics`` and
    penalise the disagreement.  Returns the scalar loss, differentiable
    with respect to the model's parameters.  With a ``mesh`` the batch is
    this rank's slice of a global batch ``mesh.size`` times as large, whose
    draws are made and sliced (``mesh.rows``)."""
    device = next(model.parameters()).device
    im1 = as_nchw(batch["im1"], device)
    im2 = as_nchw(batch["im2"], device)
    b, _, h, w = im1.shape
    size = b if mesh is None else b * mesh.size
    params = random_affine(
        generator, size, rows=slice(None) if mesh is None else mesh.rows(size))
    teacher = {k: teacher_out[k].detach().permute(0, 3, 1, 2)
               for k in ("flow_f_out", "flow_b_out", "occ_fw", "occ_bw")}
    im1_t, m1 = transform_image(im1, params)
    im2_t, m2 = transform_image(im2, params)
    flow_f_t = transform_flow(teacher["flow_f_out"], params)
    flow_b_t = transform_flow(teacher["flow_b_out"], params)
    occ_f = occ_b = None
    if use_occ:
        px, py = _affine_coords(params, b, h, w, device)
        occ_f = (bilinear_sample(teacher["occ_fw"], px, py) >= 0.999).float()
        occ_b = (bilinear_sample(teacher["occ_bw"], px, py) >= 0.999).float()
    with fp32_numerics():
        s_flow_f, s_flow_b, _ = model(im1_t, im2_t)
        mask = m1 * m2
        return (equivariance_loss(s_flow_f, flow_f_t, mask, occ_f,
                                  loss_type=loss_type)
                + equivariance_loss(s_flow_b, flow_b_t, mask, occ_b,
                                    loss_type=loss_type))
