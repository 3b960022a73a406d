"""The PyTorch port's forward with SGU upsampling against the JAX
``forward``, on the CPU.

The configuration is the eval recipe with ``if_sgu_upsample=True``, fp32.
Both packages get the full checkpoint (``assets/synthetic_trained.npz``,
its ``sgu_*`` weights included) and the same numpy images.  The mask
threshold is 0.9999 on both sides, as in ``test_torch_port_model.py``.
"""

from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import upflow_pytorch_tpu.ops.warp as jwarp
from upflow_pytorch_tpu.config import UPFlowConfig as JaxConfig
from upflow_pytorch_tpu.models import upflow as jupflow

import upflow_pytorch_tpu_torch.ops.warp as pwarp
from upflow_pytorch_tpu_torch.config import UPFlowConfig
from upflow_pytorch_tpu_torch.models import upflow as pupflow
from upflow_pytorch_tpu_torch.ops.kernels import feature_warp as pfw
from upflow_pytorch_tpu_torch.ops.kernels import sgu_blend as psb
from upflow_pytorch_tpu_torch.ops.kernels import sgu_final as psf

NPZ = str(Path(__file__).resolve().parents[1] / "assets"
          / "synthetic_trained.npz")
SGU_KNOBS = dict(if_norm_before_cost_volume=True,
                 norm_moments_across_channels=False,
                 norm_moments_across_images=False,
                 if_sgu_upsample=True, if_use_cor_pytorch=False)
RELAXED_THRESHOLD = 0.9999
BAR = 3e-4  # px, final and per-level flows
# (knobs, (batch, height, width)): aligned, ragged, and the unfused
# correlation knob
CASES = [(SGU_KNOBS, (2, 64, 128)),
         (SGU_KNOBS, (1, 72, 104)),
         (dict(SGU_KNOBS, if_use_cor_pytorch=True), (1, 64, 96))]


def _images(b, h, w, seed):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, h, w, 3).astype(np.float32),
            rng.rand(b, h, w, 3).astype(np.float32))


@pytest.fixture(scope="module")
def jax_params():
    """The whole checkpoint as a flax tree, SGU weights included."""
    with np.load(NPZ) as z:
        flat = {tuple(k.split("/")): z[k] for k in z.files}
    return flax.traverse_util.unflatten_dict(flat)


@pytest.fixture(scope="module")
def outputs(jax_params):
    """Per case: the JAX forward, the port's forward, and the SGU head
    outputs (inter-flow and mask logit) of each of the port's SGU calls."""
    results = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwarp, "MASK_THRESHOLD", RELAXED_THRESHOLD)
        mp.setattr(pwarp, "MASK_THRESHOLD", RELAXED_THRESHOLD)
        for knobs, (b, h, w) in CASES:
            im1, im2 = _images(b, h, w, seed=h + w + 1)
            jmodel = jupflow.build_model(JaxConfig().updated(knobs))
            ref = jax.jit(lambda p, a, c: jupflow.forward(jmodel, p, a, c))(
                jax_params, jnp.asarray(im1), jnp.asarray(im2))
            ref = jax.tree_util.tree_map(np.asarray, ref)
            model = pupflow.build_model(UPFlowConfig().updated(knobs),
                                        device="cpu", weights=NPZ)
            heads = []
            hook = model.sgi_model.dense_estimator_mask.register_forward_hook(
                lambda mod, args, out: heads.append(out[1]))
            out = pupflow.forward(model, im1, im2)
            hook.remove()
            results.append((ref, out, heads))
    return results


def _max_err(out: torch.Tensor, ref: np.ndarray) -> float:
    assert tuple(out.shape) == ref.shape
    return float(np.abs(out.numpy() - ref).max())


@pytest.mark.parametrize("case", range(len(CASES)))
def test_sgu_forward_matches_jax(outputs, case):
    ref, out, _ = outputs[case]
    b, h, w = CASES[case][1]
    for key in ("flow_f_out", "flow_b_out"):
        assert out[key].shape == (b, h, w, 2)
        assert torch.isfinite(out[key]).all()
        err = _max_err(out[key], ref[key])
        assert err <= BAR, "%s max err %.3e" % (key, err)
    for key in ("occ_fw", "occ_bw"):
        assert out[key].shape == (b, h, w, 1)
        frac = float(np.mean(out[key].numpy() != ref[key]))
        assert frac < 1e-3, "%s disagree on %.4f of pixels" % (key, frac)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_sgu_per_level_flows_match_jax(outputs, case):
    ref, out, _ = outputs[case]
    assert len(out["flows"]) == len(ref["flows"]) == 5
    for i, ((pf, pb), (rf, rb)) in enumerate(zip(out["flows"],
                                                 ref["flows"])):
        ef, eb = _max_err(pf, rf), _max_err(pb, rb)
        assert ef <= BAR and eb <= BAR, \
            "level %d (finest-first): fwd %.3e bwd %.3e" % (i, ef, eb)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_sgu_inter_flows_are_not_trivial(outputs, case):
    """Every SGU call (two directions at decode levels 1-4 and at the
    final stage) moves its samples by a visible inter-flow, so the bars
    above hold the warp-and-blend path and not an identity."""
    _, _, heads = outputs[case]
    assert len(heads) == 10
    for x_out in heads:
        assert x_out.shape[1] == 3
        assert float(x_out[:, :2].abs().max()) > 0.05
        mask = torch.sigmoid(x_out[:, 2])
        assert 0.0 < float(mask.min()) and float(mask.max()) < 1.0


def test_sgu_forward_runs_plain_versions_only_on_the_cpu(outputs):
    """The CPU forward launched no kernel and called no plain version on a
    CUDA tensor."""
    assert (pfw.feature_warp.launches, psb.sgu_blend.launches,
            psf.sgu_final.launches) == (0, 0, 0)
    assert all(f.cuda_calls == 0 for f in (
        pfw.feature_warp_plain, psb.sgu_blend_plain, psf.sgu_final_plain))
