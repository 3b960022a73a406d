"""The yardstick: at a small size on the CPU the plain reference agrees
with the port's forward and training step, the port's bf16 forward stays
inside the serving cells' limits while the fp8 control does not, and the
op files count the bound of PERF.md's kernel table at B=4 384x1280."""

from __future__ import annotations

import json

import pytest
import torch

from conftest import REPO

from benchmark.core import instrument, peaks
from benchmark.core.spec import Spec
from benchmark.drivers import train_steps
from benchmark.reference import amsgrad, losses, lowp, npz, synthetic
from benchmark.reference import upflow as reference

WEIGHTS = str(REPO / "assets" / "synthetic_trained.npz")
CONF = json.loads((REPO / "benchmark" / "configs" /
                   "upflow_sgu_bf16_eval.json").read_text())
TRAIN_CONF = json.loads((REPO / "benchmark" / "configs" /
                         "upflow_finetune_fp32_train.json").read_text())
NUM = reference.Numerics(mask_threshold=CONF["mask_threshold"])
MOTION = {"max_shift": 6.0, "max_rot": 0.01, "max_zoom": 0.02}
SERVE_LIMITS = json.loads((REPO / "benchmark" / "limits" /
                           "serve_bf16_kitti_b1.json").read_text())


def port_model(dtype: str, conf=CONF):
    from upflow_pytorch_tpu_torch.config import UPFlowConfig
    from upflow_pytorch_tpu_torch.models import upflow

    return upflow, upflow.build_model(
        UPFlowConfig().updated(dict(conf["upflow"], compute_dtype=dtype)),
        "cpu", weights=WEIGHTS)


@pytest.fixture(scope="module")
def pairs():
    return synthetic.render(987654321987, range(2), (70, 150), (64, 128),
                            MOTION, "cpu")


def gaps(out, ref):
    epe = max(float((out[k] - ref[k]).norm(dim=-1).mean())
              for k in ("flow_f_out", "flow_b_out"))
    occ = max(float((out[k] != ref[k]).float().mean())
              for k in ("occ_fw", "occ_bw"))
    return {"flow_epe_px": epe, "occ_differ_share": occ}


def test_synthetic_pairs_repeat_from_the_seed(pairs):
    again = synthetic.render(987654321987, range(2), (70, 150), (64, 128),
                             MOTION, "cpu")
    assert all(torch.equal(pairs[k], again[k]) for k in pairs)
    other = synthetic.render(987654321988, range(2), (70, 150), (64, 128),
                             MOTION, "cpu")
    assert not torch.equal(pairs["im1"], other["im1"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_against_the_port(pairs, dtype):
    upflow, model = port_model(dtype)
    out = upflow.forward(model, pairs["im1"].numpy(), pairs["im2"].numpy())
    with torch.no_grad():
        ref = reference.forward(npz.load_params(WEIGHTS, "cpu"),
                                pairs["im1"], pairs["im2"], NUM)
        ctl = reference.forward(npz.load_params(WEIGHTS, "cpu"),
                                pairs["im1"], pairs["im2"],
                                reference.Numerics(lowp.fp8_e4m3,
                                                   NUM.mask_threshold))
    got = gaps(out, ref)
    if dtype == "float32":
        # the same arithmetic but for the order of the moments' sums
        assert got["flow_epe_px"] < 1e-5 and got["occ_differ_share"] == 0
    else:
        control = gaps(ctl, ref)
        for k, limit in SERVE_LIMITS.items():
            assert got[k] < limit < control[k], (k, got, control)


def test_train_steps_against_the_port():
    from upflow_pytorch_tpu_torch.config import TrainerConfig, UPFlowConfig
    from upflow_pytorch_tpu_torch.train import step

    conf = UPFlowConfig().updated(TRAIN_CONF["upflow"])
    # at 128x256 the coarsest level has 2x4 pixels; smaller, its moments
    # over one or two pixels make its gradients swing with round-off
    batches = [synthetic.render(5555, range(2 * i, 2 * i + 2), (136, 264),
                                (128, 256), MOTION, "cpu") for i in range(3)]
    model, state, opt = step.create_train_state(
        conf, TrainerConfig().updated(TRAIN_CONF["trainer"]), "cpu", WEIGHTS)
    train_step = step.make_train_step(model, opt)
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    got_loss = []
    for i, batch in enumerate(batches):
        state, metrics = train_step(state, batch)
        got_loss.append(float(metrics["total_loss"]))
        if i == 0:
            got_grad = {train_steps.leaf_of(k): float(
                opt.state[p]["exp_avg"].norm()) / 0.1
                for k, p in model.named_parameters()}
    got_change = {train_steps.leaf_of(k): float((p.detach() - start[k])
                                                .norm())
                  for k, p in model.named_parameters()}

    p = npz.load_params(WEIGHTS, "cpu")
    ref_start = {k: v.clone() for k, v in p.items()}
    for v in p.values():
        v.requires_grad_(True)
    ref_opt = amsgrad.AMSGrad(p, 1e-4, 1e-4)
    ref_loss = []
    for i, batch in enumerate(batches):
        total = losses.loss_terms(p, batch, 1.0, 0.01, NUM)["total_loss"]
        used = ref_opt.step(dict(zip(p, torch.autograd.grad(
            total, list(p.values())))))
        ref_loss.append(float(total.detach()))
        if i == 0:
            ref_grad = {k: float(g.norm()) for k, g in used.items()}
    ref_change = {k: float((v.detach() - ref_start[k]).norm())
                  for k, v in p.items()}
    assert set(got_grad) == set(ref_grad)
    assert max(abs(a - b) / b for a, b in zip(got_loss, ref_loss)) < 1e-3
    assert train_steps.leaf_gap(got_grad, ref_grad, list(ref_grad)) < 1e-3
    assert train_steps.leaf_gap(got_change, ref_change,
                                list(ref_change)) < 2e-2


# PERF.md's kernel table, "bound ms" summed over a B=4 384x1280 SGU
# forward's calls: fp32 rows and bf16 rows
PERF_BOUND_MS = {
    "float32": {"correlation": 0.00054, "feature_warp": 0.0787,
                "corr_norm": 0.0644, "warp": 0.0282, "sgu_blend": 0.00273,
                "sgu_final": 0.0109},
    "bfloat16": {"correlation": 0.00046, "feature_warp": 0.0404,
                 "corr_norm": 0.0487, "warp": 0.0282, "sgu_blend": 0.00214,
                 "sgu_final": 0.0109, "conv3x3_seg": 1.85},
}
CALLS = {"correlation": 2, "feature_warp": 18, "corr_norm": 8, "warp": 2,
         "sgu_blend": 4, "sgu_final": 2, "conv3x3_seg": 86}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_op_bounds_match_the_kernel_table(dtype):
    upflow, model = port_model(dtype)
    im = torch.rand(4, 384, 1280, 3)
    calls: list = []
    with instrument.op_calls(Spec(REPO).ops(), calls) as found:
        upflow.forward(model, im, im)
    assert sorted(found) == sorted(CALLS)
    per_op = {}
    for name, nbytes, flops, kind in calls:
        n, ms = per_op.get(name, (0, 0.0))
        per_op[name] = (n + 1, ms + peaks.bound_s(nbytes, flops, kind) * 1e3)
    assert set(per_op) == set(PERF_BOUND_MS[dtype])
    for name, want in PERF_BOUND_MS[dtype].items():
        n, ms = per_op[name]
        assert n == CALLS[name]
        assert ms == pytest.approx(want, rel=0.012), name
