"""The PyTorch port's bf16 forward against the JAX bf16 ``forward``, on the
CPU.

The configuration is the eval recipe with SGU upsampling and
``compute_dtype="bfloat16"``; both packages get the whole checkpoint
(``assets/synthetic_trained.npz``) and the same numpy images, at mask
threshold 0.9999 (as ``test_torch_port_model.py``).

Two correct bf16 forwards differ visibly, so the whole-model bars are
loose and the tight ones are at the op and stack level
(``test_torch_port_bf16.py``).  The JAX package itself, run once by hand
on case (1, 128, 256) with the Pallas conv forced in interpret mode
(``tests/test_blocks_stored_path.py``'s wiring; 72 s) against its XLA
convs (the CPU's route), differs by: final flow mean |diff| 7.2e-3 px,
p99.9 0.16 px, max 0.82 px, occlusion masks on 3.6e-3 of pixels; per
level only at the finest level, the one at or above the kernel's pixel
gate (max 0.14 px).  The bars are twice that: mean < 1.2e-2 px and p99.9
< 0.5 px for the final and every level's flows, occlusion disagreement
< 7.2e-3.  Measured port against JAX (XLA): final mean 2.7e-3, 2.7e-3 and
1.0e-2 px, p99.9 0.071, 0.059 and 0.17 px, occlusion 2.7e-3, 2.0e-3 and
5.2e-3, for the three cases in order.

On the CPU the JAX package takes its XLA convs everywhere, and the port
its kernel route (the plain version of ``conv3x3_seg``) where the
predicate of ``ops/conv.py`` says: in case (1, 128, 256) at decode level 4
(32 x 64 = 2048 pixels) and the final SGU stage, in the other two cases
nowhere.  The port also keeps the fused cost-volume semantics at every
level >= 1 (normalised maps not rounded to bf16), where the JAX package
on the CPU rounds them.
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
from upflow_pytorch_tpu_torch.ops import conv as pconv_ops
from upflow_pytorch_tpu_torch.ops.kernels import conv3x3_seg as pseg

NPZ = str(Path(__file__).resolve().parents[1] / "assets"
          / "synthetic_trained.npz")
BF16_KNOBS = dict(if_norm_before_cost_volume=True,
                  norm_moments_across_channels=False,
                  norm_moments_across_images=False,
                  if_sgu_upsample=True, if_use_cor_pytorch=False,
                  compute_dtype="bfloat16")
RELAXED_THRESHOLD = 0.9999
MEAN_BAR, P999_BAR = 1.2e-2, 0.5   # px
OCC_BAR = 7.2e-3                   # share of pixels
# (batch, height, width) and the conv3x3_seg calls of one forward
CASES = [((2, 64, 128), 0), ((1, 72, 104), 0), ((1, 128, 256), 48)]


def _images(b, h, w, seed):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, h, w, 3).astype(np.float32),
            rng.rand(b, h, w, 3).astype(np.float32))


@pytest.fixture(scope="module")
def outputs():
    """Per case: the JAX bf16 forward, the port's, and the number of
    conv3x3_seg calls in the port's forward."""
    with np.load(NPZ) as z:
        params = flax.traverse_util.unflatten_dict(
            {tuple(k.split("/")): z[k] for k in z.files})
    jmodel = jupflow.build_model(JaxConfig().updated(BF16_KNOBS))
    jfwd = jax.jit(lambda p, a, c: jupflow.forward(jmodel, p, a, c))
    model = pupflow.build_model(UPFlowConfig().updated(BF16_KNOBS),
                                device="cpu", weights=NPZ)
    calls = []
    seg = pconv_ops.conv3x3_seg
    results = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwarp, "MASK_THRESHOLD", RELAXED_THRESHOLD)
        mp.setattr(pwarp, "MASK_THRESHOLD", RELAXED_THRESHOLD)
        mp.setattr(pconv_ops, "conv3x3_seg",
                   lambda *a, **k: calls.append(1) or seg(*a, **k))
        for (b, h, w), _ in CASES:
            im1, im2 = _images(b, h, w, seed=h + w + 2)
            ref = jax.tree_util.tree_map(
                np.asarray, jfwd(params, jnp.asarray(im1), jnp.asarray(im2)))
            del calls[:]
            out = pupflow.forward(model, im1, im2)
            results.append((ref, out, len(calls)))
    return results


def _diffs(outs, refs):
    d = np.concatenate([np.abs(o.numpy() - r).ravel()
                        for o, r in zip(outs, refs)])
    return d.mean(), np.quantile(d, 0.999)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_bf16_forward_matches_jax(outputs, case):
    ref, out, _ = outputs[case]
    b, h, w = CASES[case][0]
    for key in ("flow_f_out", "flow_b_out"):
        assert out[key].shape == (b, h, w, 2)
        assert out[key].dtype == torch.float32
        assert torch.isfinite(out[key]).all()
    mean, p999 = _diffs([out["flow_f_out"], out["flow_b_out"]],
                        [ref["flow_f_out"], ref["flow_b_out"]])
    assert mean < MEAN_BAR and p999 < P999_BAR, (mean, p999)
    for key in ("occ_fw", "occ_bw"):
        assert out[key].shape == (b, h, w, 1)
        frac = float(np.mean(out[key].numpy() != ref[key]))
        assert frac < OCC_BAR, "%s disagree on %.4f of pixels" % (key, frac)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_bf16_per_level_flows_match_jax(outputs, case):
    ref, out, _ = outputs[case]
    assert len(out["flows"]) == len(ref["flows"]) == 5
    for i, (pair, ref_pair) in enumerate(zip(out["flows"], ref["flows"])):
        assert all(t.dtype == torch.float32 for t in pair)
        mean, p999 = _diffs(pair, ref_pair)
        assert mean < MEAN_BAR and p999 < P999_BAR, \
            "level %d (finest-first): mean %.3e p99.9 %.3e" % (i, mean, p999)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_bf16_kernel_route_follows_the_predicate(outputs, case):
    """In (1, 128, 256) the two directions' estimator (6 convs) and
    context network (6) at level 4 and the SGU estimator (6) at level 4
    and the final stage take conv3x3_seg: 48 calls.  The smaller cases
    stay under the 2048-pixel gate everywhere."""
    _, _, calls = outputs[case]
    assert calls == CASES[case][1]


def test_bf16_forward_runs_plain_versions_only_on_the_cpu(outputs):
    assert pseg.conv3x3_seg.launches == 0
    assert pseg.conv3x3_seg_plain.cuda_calls == 0


def test_bf16_model_takes_the_same_fp32_parameters():
    """``params_from_jax`` feeds both dtypes: the bf16 model loads all 80
    checkpoint arrays, skips none, and holds the fp32 model's parameters,
    in fp32."""
    knobs = dict(BF16_KNOBS, compute_dtype="float32")
    m32 = pupflow.build_model(UPFlowConfig().updated(knobs), device="cpu",
                              weights=NPZ)
    m16 = pupflow.build_model(UPFlowConfig().updated(BF16_KNOBS),
                              device="cpu", weights=NPZ)
    assert m16.dtype == torch.bfloat16 and m32.dtype == torch.float32
    assert m16.skipped_keys == [] and len(m16.state_dict()) == 80
    sd32 = m32.state_dict()
    for key, value in m16.state_dict().items():
        assert value.dtype == torch.float32
        assert torch.equal(value, sd32[key]), key
