"""Configuration of the PyTorch/CUDA port.

The same knob surface as ``upflow_pytorch_tpu.config.UPFlowConfig``: the 22
knobs of the reference ``UPFlow_net.config`` with their defaults, the
extensions below them, and the ``updated`` / ``get_name`` helpers of the
reference ``tools.abstract_config``; ``RAFTConfig`` and ``GMFlowConfig``,
the RAFT and GMFlow networks served on the same entry; ``OcclusionCheck``,
the settings of the occlusion check that the entry runs on every
network's flows; ``KittiTrainDataConfig``, the KITTI multiview training
data's knobs; and ``TrainerConfig``, the trainer's knobs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple


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


def _check_dtype(compute_dtype: str) -> None:
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError("compute_dtype must be one of %s, got %r"
                         % (" or ".join(map(repr, COMPUTE_DTYPES)),
                            compute_dtype))


@dataclasses.dataclass(frozen=True)
class OcclusionCheck:
    """The forward-backward occlusion check that ``models/entry.py``
    runs on a network's flows (``models/occlusion.py::occ_check``): UPFlow's
    four occlusion knobs with their published defaults, which are its eval
    settings.  ``UPFlowConfig`` takes its knobs' defaults from here and
    names its own values as ``occlusion``; RAFT and GMFlow name these."""

    occ_type: str = "for_back_check"
    alpha_1: float = 0.1
    alpha_2: float = 0.5
    occ_check_obj_out_all: str = "obj"  # 'obj' | 'out' | 'all'


@dataclasses.dataclass(frozen=True)
class UPFlowConfig(ConfigBase):
    """All 22 knobs of ``UPFlow_net.config``, with the reference defaults,
    plus the extensions at the bottom."""

    # --- occlusion check
    occ_type: str = OcclusionCheck.occ_type
    alpha_1: float = OcclusionCheck.alpha_1
    alpha_2: float = OcclusionCheck.alpha_2
    occ_check_obj_out_all: str = OcclusionCheck.occ_check_obj_out_all
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
        _check_dtype(self.compute_dtype)

    @property
    def occlusion(self) -> OcclusionCheck:
        """The entry's occlusion check: this configuration's knobs."""
        return OcclusionCheck(self.occ_type, self.alpha_1, self.alpha_2,
                              self.occ_check_obj_out_all)

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
class RAFTConfig(ConfigBase):
    """RAFT (Teed & Deng, ECCV 2020; princeton-vl/RAFT ``core/raft.py``),
    the full model, served on the same entry as UPFlow
    (``models/entry.py::forward``).

    The widths are the published ones and fixed (the properties below),
    as are ``InputPadder``'s 'kitti' padding and the entry's occlusion
    check with UPFlow's eval settings (``occlusion``); the fields are what
    a deployment chooses: the update iterations (``evaluate.py`` runs 24
    on KITTI) and the compute dtype (bfloat16 in place of RAFT's fp16
    ``--mixed_precision``)."""

    iters: int = 24
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'

    occlusion = OcclusionCheck()  # the entry's, at UPFlow's eval settings

    def __post_init__(self):
        _check_dtype(self.compute_dtype)
        if self.iters < 1:
            raise ValueError("iters must be at least 1, got %d" % self.iters)

    @property
    def feature_dim(self) -> int:  # the feature encoder's output
        return 256

    @property
    def hidden_dim(self) -> int:
        return 128

    @property
    def context_dim(self) -> int:
        return 128

    @property
    def encoder_dims(self) -> Tuple[int, ...]:  # conv1, layer1..3
        return (64, 64, 96, 128)

    @property
    def corr_levels(self) -> int:
        return 4

    @property
    def corr_radius(self) -> int:
        return 4


@dataclasses.dataclass(frozen=True)
class GMFlowConfig(ConfigBase):
    """GMFlow (Xu et al., CVPR 2022; haofeixu/gmflow ``gmflow/gmflow.py``),
    the model of the published ``gmflow_kitti`` checkpoint, served on the
    same entry as UPFlow: one scale at 1/8, global matching and global
    flow propagation (``corr_radius`` and ``prop_radius`` -1), a 6-block
    Transformer of one head over 2 x 2 windows, convex upsampling.

    The widths are the published ones and fixed (the properties below),
    as are ``InputPadder``'s 'kitti' padding to multiples of 16
    (``main.py``'s ``padding_factor``), the 2 x 2 window splits and the
    entry's occlusion check with UPFlow's eval settings (``occlusion``);
    the field is what a deployment chooses: the compute dtype.  At
    'bfloat16' the card serves the matching and the propagation on the
    ``global_match`` kernel, which takes bf16 operands; 'float32' runs on
    the CPU alone, and ``build_model`` refuses it for the card."""

    compute_dtype: str = "bfloat16"  # 'bfloat16' | 'float32' (CPU)

    occlusion = OcclusionCheck()  # the entry's, at UPFlow's eval settings

    def __post_init__(self):
        _check_dtype(self.compute_dtype)

    @property
    def feature_channels(self) -> int:  # the backbone's output, d_model
        return 128

    @property
    def backbone_dims(self) -> Tuple[int, ...]:
        """``backbone.py``'s ``feature_dims``: conv1 and layer1 at the
        first, layer2 and layer3 at the others."""
        return (64, 96, 128)

    @property
    def num_transformer_layers(self) -> int:
        return 6

    @property
    def num_head(self) -> int:
        return 1

    @property
    def ffn_dim_expansion(self) -> int:
        return 4

    @property
    def upsample_factor(self) -> int:
        return 8

    @property
    def attn_splits(self) -> int:  # windows a side
        return 2

    @property
    def padding_factor(self) -> int:
        return 16


@dataclasses.dataclass(frozen=True)
class KittiTrainDataConfig(ConfigBase):
    """The reference ``kitti_data_with_start_point.config`` knobs with the
    JAX package's defaults; the same knobs are the arguments of
    ``data/kitti.py::KittiMultiviewDataset``, which nothing here builds
    from this class."""

    crop_size: Tuple[int, int] = (256, 832)
    rho: int = 8
    swap_images: bool = True
    normalize: bool = True
    repeat: Optional[int] = None
    horizontal_flip_aug: bool = True
    mv_type: Optional[str] = None  # '2015' | '2012'


@dataclasses.dataclass(frozen=True)
class TrainerConfig(ConfigBase):
    """The reference ``Trainer.Config`` knobs with the JAX package's names
    and defaults: the run's directory, batch, loader threads, epochs and
    logging period; Adam (AMSGrad) with ``lr`` and L2 ``weight_decay``,
    the learning rate multiplied by ``scheduler_gamma`` every
    ``batch_per_epoch`` steps; the seed of the initial weights and of the
    loader's order; the in-training evaluation's edge padding; and the
    equivariance pass (``eq_loss_weight`` 0 = off).

    ``data_axis`` is the number of data-parallel ranks, one card each
    (``parallel/``); ``batchsize`` is the global batch, split evenly over
    them, so it must be a multiple of ``data_axis``.  Above 1 the
    ``Trainer`` needs a process group of that size
    (``parallel/mesh.py::init_distributed``, e.g. under ``torchrun``)."""

    exp_dir: str = "./demo_exp"
    batchsize: int = 2
    num_workers: int = 4
    n_epoch: int = 1000
    batch_per_epoch: int = 500
    batch_per_print: int = 20
    lr: float = 1e-4
    weight_decay: float = 1e-4
    scheduler_gamma: float = 1.0
    data_axis: int = 1
    seed: int = 0
    eval_pad_to_multiple: Optional[int] = 64
    eq_loss_weight: float = 0.0
    eq_loss_use_occ: bool = True
    # 'L1': the reference's masked L1; 'abs_robust': the robust penalty
    eq_loss_type: str = "abs_robust"

    def __post_init__(self):
        if self.data_axis < 1 or self.batchsize % self.data_axis:
            raise ValueError(
                "batchsize=%d is the global batch: it must split evenly "
                "over data_axis=%d ranks" % (self.batchsize, self.data_axis))
