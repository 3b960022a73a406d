"""Adam with AMSGrad and L2 weight decay, as the UPFlow recipe trains
(``Adam(lr, amsgrad=True, weight_decay)``): the decay is added to the
gradient, the running maximum is taken of the raw second moment, and both
moments are bias-corrected at the step."""

from __future__ import annotations

import math
from typing import Dict

import torch


class AMSGrad:
    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 weight_decay: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.params = params
        self.lr, self.wd, self.betas, self.eps = lr, weight_decay, betas, eps
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.vmax = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Updates the parameters in place; returns the gradients as the
        update used them, the weight decay included."""
        b1, b2 = self.betas
        self.t += 1
        step = self.lr / (1 - b1 ** self.t)
        bc2 = math.sqrt(1 - b2 ** self.t)
        used = {}
        for k, p in self.params.items():
            g = grads[k] + self.wd * p
            used[k] = g
            self.m[k] = b1 * self.m[k] + (1 - b1) * g
            self.v[k] = b2 * self.v[k] + (1 - b2) * g * g
            self.vmax[k] = torch.maximum(self.vmax[k], self.v[k])
            p -= step * self.m[k] / (self.vmax[k].sqrt() / bc2 + self.eps)
        return used
