"""Configuration of the PyTorch/CUDA port.

The same knob surface as ``upflow_pytorch_tpu.config.UPFlowConfig``: the 22
knobs of the reference ``UPFlow_net.config`` with their defaults, the
extensions below them, and the ``updated`` / ``get_name`` helpers of the
reference ``tools.abstract_config``; and ``TrainerConfig``, the trainer's
knobs that the training step reads.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple


class ConfigBase:
    """``updated(d)`` returns a copy with only pre-declared fields set
    (unknown keys are ignored); ``get_name()`` builds the sorted
    ``key|value_`` experiment-name string."""

    def updated(self, data: Dict[str, Any]):
        known = {f.name for f in dataclasses.fields(self)}
        accepted = {k: v for k, v in data.items() if k in known}
        return dataclasses.replace(self, **accepted)

    def get_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def get_name(self) -> str:
        items = sorted(dataclasses.asdict(self).items())
        return "".join("%s|%s_" % (k, v) for k, v in items)


COMPUTE_DTYPES = ("float32", "bfloat16")


@dataclasses.dataclass(frozen=True)
class UPFlowConfig(ConfigBase):
    """All 22 knobs of ``UPFlow_net.config``, with the reference defaults,
    plus the extensions at the bottom."""

    # --- occlusion check
    occ_type: str = "for_back_check"
    alpha_1: float = 0.1
    alpha_2: float = 0.5
    occ_check_obj_out_all: str = "obj"  # 'obj' | 'out' | 'all'
    stop_occ_gradient: bool = False
    # --- smoothness loss
    smooth_level: str = "final"  # 'final' | '1/4'
    smooth_type: str = "edge"  # 'edge' | 'delta'
    smooth_order_1_weight: float = 1.0
    smooth_order_2_weight: float = 0.0
    # --- photometric loss
    photo_loss_type: str = "abs_robust"  # abs_robust | charbonnier | L1 | SSIM
    photo_loss_delta: float = 0.4
    photo_loss_use_occ: bool = False
    photo_loss_census_weight: float = 0.0
    # --- cost-volume feature normalization
    if_norm_before_cost_volume: bool = False
    norm_moments_across_channels: bool = True
    norm_moments_across_images: bool = True
    # --- pyramid distillation
    multi_scale_distillation_weight: float = 0.0
    multi_scale_distillation_style: str = "upup"  # 'down' | 'upup'
    multi_scale_distillation_occ: bool = True
    # --- misc
    if_froze_pwc: bool = False
    input_or_sp_input: float = 1  # 1: raw input; else use im1_sp/im2_sp
    if_use_boundary_warp: bool = True
    if_sgu_upsample: bool = False
    # Reference knob selecting the unfused correlation: here the decoder
    # runs masked warp -> torch normalisation -> correlation kernel
    # instead of the fused warp/normalise/correlate path.
    if_use_cor_pytorch: bool = False

    # --- extensions (not in the reference) ---
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'
    remat: bool = False
    search_range: int = 4
    output_level: int = 4

    def __post_init__(self):
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError("compute_dtype must be one of %s, got %r"
                             % (" or ".join(map(repr, COMPUTE_DTYPES)),
                                self.compute_dtype))

    @property
    def num_chs(self) -> Tuple[int, ...]:
        return (3, 16, 32, 64, 96, 128, 196)

    @property
    def estimator_f_channels(self) -> Tuple[int, ...]:
        return (128, 128, 96, 64, 32)

    @property
    def context_f_channels(self) -> Tuple[int, ...]:
        return (128, 128, 128, 96, 64, 32, 2)

    @property
    def dim_corr(self) -> int:
        return (self.search_range * 2 + 1) ** 2


@dataclasses.dataclass(frozen=True)
class TrainerConfig(ConfigBase):
    """The knobs of the reference ``Trainer.Config`` that the training step
    reads, with their defaults: Adam (AMSGrad) with ``lr`` and L2
    ``weight_decay``, the learning rate multiplied by ``scheduler_gamma``
    every ``batch_per_epoch`` steps, and the seed of the initial weights."""

    batch_per_epoch: int = 500
    lr: float = 1e-4
    weight_decay: float = 1e-4
    scheduler_gamma: float = 1.0
    seed: int = 0
