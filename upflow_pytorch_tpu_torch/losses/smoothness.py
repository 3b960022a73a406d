"""Smoothness losses, NCHW.

Port of ``upflow_pytorch_tpu.losses.smoothness``: the reference's
``edge_aware_smoothness_order1/order2`` and ``flow_smooth_delta``.
``_grad_h`` differences along the rows (dim 2), ``_grad_w`` along the
columns (dim 3); the image weights average |gradient| over the channels.
"""

from __future__ import annotations

import torch


def _grad_h(x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    return x[:, :, :-stride, :] - x[:, :, stride:, :]


def _grad_w(x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    return x[:, :, :, :-stride] - x[:, :, :, stride:]


def _edge_weight(g: torch.Tensor) -> torch.Tensor:
    return torch.exp(-torch.abs(g).mean(dim=1, keepdim=True))


def edge_aware_smoothness_order1(img: torch.Tensor,
                                 pred: torch.Tensor) -> torch.Tensor:
    weights_h = _edge_weight(_grad_h(img))
    weights_w = _edge_weight(_grad_w(img))
    s_h = torch.abs(_grad_h(pred)) * weights_h
    s_w = torch.abs(_grad_w(pred)) * weights_w
    return s_h.mean() + s_w.mean()


def edge_aware_smoothness_order2(img: torch.Tensor,
                                 pred: torch.Tensor) -> torch.Tensor:
    pred_hh = _grad_h(_grad_h(pred))
    pred_ww = _grad_w(_grad_w(pred))
    weights_h = _edge_weight(_grad_h(img, 2))
    weights_w = _edge_weight(_grad_w(img, 2))
    return ((torch.abs(pred_hh) * weights_h).mean()
            + (torch.abs(pred_ww) * weights_w).mean())


def flow_smooth_delta(flow: torch.Tensor,
                      if_second_order: bool = False) -> torch.Tensor:
    dh = _grad_h(flow)
    dw = _grad_w(flow)
    loss = torch.abs(dh).mean() + torch.abs(dw).mean()
    if if_second_order:
        loss = (loss + torch.abs(_grad_h(dh)).mean()
                + torch.abs(_grad_w(dh)).mean()
                + torch.abs(_grad_h(dw)).mean()
                + torch.abs(_grad_w(dw)).mean())
    return loss
