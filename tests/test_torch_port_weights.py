"""The PyTorch port's weight loading against the JAX package's, on the CPU.

``params_from_jax`` turns a flax ``.npz`` snapshot into the port's state
dict; it must give the same keys and values as the JAX package's own
export (``params_to_torch_state_dict``) and load strictly into the port's
model, built with SGU (all 80 arrays) or without it (the 20 SGU arrays
skipped).
"""

from pathlib import Path

import flax
import numpy as np
import pytest
import torch

from upflow_pytorch_tpu.checkpoint.torch_import import (
    params_to_torch_state_dict)
from upflow_pytorch_tpu.config import UPFlowConfig as JaxConfig

from upflow_pytorch_tpu_torch.checkpoint.convert import params_from_jax
from upflow_pytorch_tpu_torch.checkpoint.npz_io import load_npz_flat
from upflow_pytorch_tpu_torch.config import UPFlowConfig
from upflow_pytorch_tpu_torch.models.upflow import UPFlowNet, build_model

NPZ = str(Path(__file__).resolve().parents[1] / "assets"
          / "synthetic_trained.npz")
SLICE_KNOBS = dict(if_norm_before_cost_volume=True,
                   norm_moments_across_channels=False,
                   norm_moments_across_images=False,
                   if_sgu_upsample=False, if_use_cor_pytorch=False)


@pytest.fixture(scope="module")
def flat():
    return load_npz_flat(NPZ)


def test_npz_reads_as_flat_paths(flat):
    assert len(flat) == 80
    assert sum(v.size for v in flat.values()) == 3494549
    assert all(k.startswith("params/") for k in flat)
    kernel = flat["params/conv_1x1_0/conv/kernel"]
    assert kernel.shape == (1, 1, 196, 32) and kernel.dtype == np.float32


def test_params_from_jax_equals_jax_export(flat):
    jax_tree = flax.traverse_util.unflatten_dict(
        {tuple(k.split("/")): v for k, v in flat.items()})
    ref = params_to_torch_state_dict(jax_tree)
    sd = params_from_jax(flat)
    assert sorted(sd) == sorted(ref)
    for key, value in ref.items():
        assert sd[key].dtype == torch.float32
        np.testing.assert_array_equal(sd[key].numpy(), value, err_msg=key)


def test_params_load_strictly_into_model_without_sgu(flat):
    conf = UPFlowConfig().updated(SLICE_KNOBS)
    model = build_model(conf, device="cpu", weights=NPZ)
    sd = params_from_jax(flat)
    assert model.skipped_keys == sorted(k for k in sd
                                        if k.startswith("sgi_model."))
    assert len(model.skipped_keys) == 20
    got = model.state_dict()
    assert len(got) == 60
    for key, value in got.items():
        assert torch.equal(value, sd[key]), key
    assert sum(p.numel() for p in model.parameters()) == 3354146


def test_params_load_strictly_into_model_with_sgu(flat):
    conf = UPFlowConfig().updated(dict(SLICE_KNOBS, if_sgu_upsample=True))
    model = build_model(conf, device="cpu", weights=NPZ)
    assert model.skipped_keys == []
    sd = params_from_jax(flat)
    got = model.state_dict()
    assert len(got) == len(sd) == 80
    for key, value in got.items():
        assert torch.equal(value, sd[key]), key
    sgu = sum(p.numel() for p in model.sgi_model.parameters())
    assert sgu == 140403
    assert sum(p.numel() for p in model.parameters()) == 3354146 + sgu
    assert sorted(k for k in got if k.startswith("sgi_model.")) == sorted(
        ["sgi_model.dense_estimator_mask.%s.0.%s" % (m, leaf)
         for m in ("conv1", "conv2", "conv3", "conv4", "conv5", "conv_last")
         for leaf in ("weight", "bias")]
        + ["sgi_model.upsample_output_conv.%d.0.%s" % (i, leaf)
           for i in range(4) for leaf in ("weight", "bias")])


def test_params_from_jax_raises_on_missing_model_key(flat):
    keys = list(UPFlowNet(UPFlowConfig()).state_dict().keys())
    partial = {k: v for k, v in flat.items()
               if not k.startswith("params/context_networks/conv6/")}
    with pytest.raises(KeyError, match="context_networks.convs.6.0"):
        params_from_jax(partial, keys)


def test_random_init_is_seeded():
    a = UPFlowNet(UPFlowConfig(), torch.Generator().manual_seed(3))
    b = UPFlowNet(UPFlowConfig(), torch.Generator().manual_seed(3))
    c = UPFlowNet(UPFlowConfig(), torch.Generator().manual_seed(4))
    wa, wb, wc = (m.flow_estimators.conv1[0].weight for m in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    # Kaiming normal, fan_in: std sqrt(2 / (3 * 3 * 115))
    assert abs(wa.std().item() - (2.0 / (9 * 115)) ** 0.5) < 2e-3


def test_config_matches_jax_config():
    ours, ref = UPFlowConfig(), JaxConfig()
    assert ours.get_dict() == ref.get_dict()
    assert ours.get_name() == ref.get_name()
    upd = dict(SLICE_KNOBS, not_a_knob=1, alpha_1=0.2)
    assert (UPFlowConfig().updated(upd).get_dict()
            == JaxConfig().updated(upd).get_dict())
    for prop in ("num_chs", "estimator_f_channels", "context_f_channels",
                 "dim_corr"):
        assert getattr(ours, prop) == getattr(ref, prop), prop
