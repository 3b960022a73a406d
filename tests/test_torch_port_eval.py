"""The PyTorch port's evaluation path against the JAX package's, on the
CPU: the synthetic pairs, the KITTI metrics, the evaluation bench, the
meters and the timer, and ``NetEvalModel`` over the port's forward.

Inputs are made with numpy from a seed and handed to both packages.  The
``NetEvalModel`` cases run the fp32 eval recipe with SGU and the trained
snapshot (``assets/synthetic_trained.npz``) at mask threshold 0.9999 on
both sides, as ``test_torch_port_sgu_model.py`` does.
"""

from pathlib import Path

import flax
import numpy as np
import pytest

import upflow_pytorch_tpu.ops.warp as jwarp
from upflow_pytorch_tpu.config import UPFlowConfig as JaxConfig
from upflow_pytorch_tpu.data import synthetic as jsyn
from upflow_pytorch_tpu.eval import bench as jbench
from upflow_pytorch_tpu.eval import metrics as jmetrics
from upflow_pytorch_tpu.models import upflow as jupflow
from upflow_pytorch_tpu.train.trainer import NetEvalModel as JaxNetEvalModel
from upflow_pytorch_tpu.utils import meters as jmeters
from upflow_pytorch_tpu.utils.timer import TimeClock as JaxTimeClock

import upflow_pytorch_tpu_torch.ops.warp as pwarp
from upflow_pytorch_tpu_torch.config import UPFlowConfig
from upflow_pytorch_tpu_torch.data import synthetic as psyn
from upflow_pytorch_tpu_torch.eval import bench as pbench
from upflow_pytorch_tpu_torch.eval import metrics as pmetrics
from upflow_pytorch_tpu_torch.models import entry
from upflow_pytorch_tpu_torch.train.trainer import NetEvalModel
from upflow_pytorch_tpu_torch.utils import meters as pmeters
from upflow_pytorch_tpu_torch.utils.timer import TimeClock

NPZ = str(Path(__file__).resolve().parents[1] / "assets"
          / "synthetic_trained.npz")
SGU_KNOBS = dict(if_norm_before_cost_volume=True,
                 norm_moments_across_channels=False,
                 norm_moments_across_images=False,
                 if_sgu_upsample=True, if_use_cor_pytorch=False)
RELAXED_THRESHOLD = 0.9999
BAR = 3e-4  # px, slice 2's bar for the SGU forward

# (n_pairs, seed, raw_hw, crop_hw): three seeds at 40x72 crops, and a
# ragged crop
DATASETS = [(1, 0, (48, 88), (40, 72)), (1, 5, (48, 88), (40, 72)),
            (1, 13, (48, 88), (40, 72)), (2, 3, (45, 77), (37, 61))]


@pytest.mark.parametrize("n,seed,raw_hw,crop_hw", DATASETS)
def test_make_dataset_equals_jax(n, seed, raw_hw, crop_hw):
    got = psyn.make_dataset(n, seed=seed, raw_hw=raw_hw, crop_hw=crop_hw)
    ref = jsyn.make_dataset(n, seed=seed, raw_hw=raw_hw, crop_hw=crop_hw)
    assert sorted(got) == sorted(ref)
    for key in ref:
        assert got[key].dtype == ref[key].dtype, key
        assert np.array_equal(got[key], ref[key]), key
    assert got["gt_flow"].shape == (n,) + crop_hw + (2,)
    pred = got["gt_flow"] + 0.25
    assert psyn.epe(pred, got["gt_flow"]) == jsyn.epe(pred, ref["gt_flow"])


def _metric_inputs(seed, empty=False):
    rng = np.random.RandomState(seed)
    gt = (rng.randn(2, 19, 23, 2) * 30).astype(np.float32)
    pred = gt + (rng.randn(2, 19, 23, 2) * 4).astype(np.float32)
    mask = (rng.rand(2, 19, 23, 1) > 0.3).astype(np.float32)
    return gt, pred, np.zeros_like(mask) if empty else mask


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("relative", [0.05, None])
def test_metrics_equal_jax(seed, relative):
    gt, pred, mask = _metric_inputs(seed)
    assert abs(pmetrics.flow_error_avg(gt, pred, mask)
               - jmetrics.flow_error_avg(gt, pred, mask)) <= 1e-12
    got = pmetrics.outlier_pct(gt, pred, mask, relative=relative)
    ref = jmetrics.outlier_pct(gt, pred, mask, relative=relative)
    assert abs(got - ref) <= 1e-12 and 0.0 < got < 100.0


def test_metrics_with_an_empty_mask_equal_jax():
    """An empty mask: EPE 0 (its denominator has an eps), F1 NaN (none)."""
    gt, pred, mask = _metric_inputs(3, empty=True)
    assert pmetrics.flow_error_avg(gt, pred, mask) == \
        jmetrics.flow_error_avg(gt, pred, mask) == 0.0
    with np.errstate(invalid="ignore", divide="ignore"):
        got = pmetrics.outlier_pct(gt, pred, mask)
        ref = jmetrics.outlier_pct(gt, pred, mask)
    assert np.isnan(got) and np.isnan(ref)


def _bench_samples(mod, n=4):
    """``test_eval_bench.py``'s samples: variable sizes like KITTI."""
    rng = np.random.RandomState(11)
    samples = []
    for i in range(n):
        h, w = 40 + i, 60 + 2 * i
        flow_occ = rng.randn(1, h, w, 2).astype(np.float32) * 8
        mask_occ = (rng.rand(1, h, w, 1) > 0.2).astype(np.float32)
        mask_noc = mask_occ * (rng.rand(1, h, w, 1) > 0.3).astype(np.float32)
        samples.append(mod.EvalSample(
            im1=rng.rand(1, h, w, 3).astype(np.float32),
            im2=rng.rand(1, h, w, 3).astype(np.float32),
            flow_occ=flow_occ, mask_occ=mask_occ,
            flow_noc=flow_occ.copy(), mask_noc=mask_noc,
            name="img_%d" % i))
    return samples


def _models(mod):
    class GTModel(mod.AbsTestModel):
        def eval_forward(self, im1, im2, gt, *args):
            return gt

    class BiasedModel(mod.AbsTestModel):
        """Adds a constant (4, 3) px error: EPE = 5 everywhere."""

        def eval_forward(self, im1, im2, gt, *args):
            return gt + np.array([4.0, 3.0], np.float32)

    return GTModel(), BiasedModel()


def _case_gt_model_scores_zero(mod, metrics):
    res = mod.EvaluationBench(_bench_samples(mod))(_models(mod)[0])
    assert res.epe_all == 0 and res.f1 == 0 and res.epe_noc == 0
    assert res.epe_occ == 0
    return res


def _case_biased_model_epe_five(mod, metrics):
    res = mod.EvaluationBench(_bench_samples(mod))(_models(mod)[1])
    np.testing.assert_allclose(res.epe_all, 5.0, rtol=1e-5)
    np.testing.assert_allclose(res.epe_noc, 5.0, rtol=1e-5)
    assert res.f1 > 0
    return res


def _case_metric_semantics(mod, metrics):
    gt = np.zeros((1, 4, 4, 2), np.float32)
    gt[0, :, :, 0] = 100.0  # large flow: the relative threshold dominates
    pred = gt.copy()
    pred[0, 0, 0] = gt[0, 0, 0] + [4.0, 0]  # err 4 < 0.05*100=5: inlier
    pred[0, 1, 1] = gt[0, 1, 1] + [6.0, 0]  # err 6 > 5: outlier
    mask = np.ones((1, 4, 4, 1), np.float32)
    epe = metrics.flow_error_avg(gt, pred, mask)
    f1 = metrics.outlier_pct(gt, pred, mask)
    np.testing.assert_allclose(epe, 10 / 16, rtol=1e-6)
    np.testing.assert_allclose(f1, 100 / 16, rtol=1e-6)
    mask[0, 1, 1] = 0  # masked-out error pixels do not count
    assert metrics.outlier_pct(gt, pred, mask) == 0.0
    return epe, f1


def _case_test_split_saves_without_metrics(mod, metrics):
    saved = []

    class Saver(mod.AbsTestModel):
        def eval_forward(self, im1, im2, gt, *args):
            return np.zeros(im1.shape[:3] + (2,), np.float32)

        def eval_save_result(self, save_name, predflow, *args, **kwargs):
            saved.append(save_name)

    samples = [mod.EvalSample(im1=np.zeros((1, 8, 8, 3), np.float32),
                              im2=np.zeros((1, 8, 8, 3), np.float32),
                              name="t_%d" % i) for i in range(3)]
    res = mod.EvaluationBench(samples, is_test_split=True)(Saver())
    assert res is None and saved == ["t_0", "t_1", "t_2"]
    return saved


BENCH_CASES = {"gt_model_scores_zero": _case_gt_model_scores_zero,
               "biased_model_epe_five": _case_biased_model_epe_five,
               "metric_semantics": _case_metric_semantics,
               "test_split_saves_without_metrics":
                   _case_test_split_saves_without_metrics}


@pytest.mark.parametrize("case", sorted(BENCH_CASES))
def test_eval_bench_cases(case):
    """The four cases of ``tests/test_eval_bench.py`` on the port's bench,
    each also giving the JAX bench's result."""
    got = BENCH_CASES[case](pbench, pmetrics)
    assert got == BENCH_CASES[case](jbench, jmetrics)


def test_meters_behave_like_jax():
    steps = [("photo_loss", 0.5, 2, "ph"), ("smooth_loss", 1.25, 1, None),
             ("photo_loss", 0.25, 3, "ignored"), ("smooth_loss", 2.0, 4, None)]
    groups = (pmeters.AvgMeterGroup(), jmeters.AvgMeterGroup())
    for name, val, num, short in steps:
        for g in groups:
            g.update(name, val, num, short_name=short)
    got, ref = groups
    assert got.print_all_losses() == ref.print_all_losses()
    for name in ref.meters:
        assert vars(got.meters[name]) == vars(ref.meters[name])
    assert got.short_names == ref.short_names
    for g in groups:
        g.reset()
    assert got.print_all_losses() == ref.print_all_losses()
    meters = (pmeters.AverageMeter(), jmeters.AverageMeter())
    for m in meters:
        assert (m.val, m.avg, m.sum, m.count) == (0.0, 0.0, 0.0, 0)
        m.update(3.0)
        m.update(1.0, 3)
    assert vars(meters[0]) == vars(meters[1])
    assert meters[0].avg == 1.5


def test_time_clock_behaves_like_jax():
    clocks = (TimeClock(), JaxTimeClock())
    for c in clocks:
        assert (c.st, c.en, c.start_flag, c.get_during()) == (0.0, 0.0,
                                                               False, 0.0)
        c.start()
        c.end()
        assert c.start_flag and c.get_during() >= 0.0
        c.reset()
        assert c.start_flag and c.st >= c.en - 1.0
    assert sorted(vars(clocks[0])) == sorted(vars(clocks[1]))


@pytest.fixture(scope="module")
def eval_flows():
    """The JAX and the port's ``NetEvalModel`` on one synthetic pair at
    (1, 72, 104), native and padded to multiples of 64, with their bench
    results: {pad: (port flow, JAX flow, port result, JAX result)}."""
    with np.load(NPZ) as z:
        params = flax.traverse_util.unflatten_dict(
            {tuple(k.split("/")): z[k] for k in z.files})
    data = psyn.make_dataset(1, seed=4, raw_hw=(80, 112), crop_hw=(72, 104))
    ones = np.ones_like(data["gt_flow"][..., :1])
    sample = (data["im1"], data["im2"], data["gt_flow"], ones,
              data["gt_flow"], ones)
    jmodel = jupflow.build_model(JaxConfig().updated(SGU_KNOBS))
    model = entry.build_model(UPFlowConfig().updated(SGU_KNOBS),
                              device="cpu", weights=NPZ)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwarp, "MASK_THRESHOLD", RELAXED_THRESHOLD)
        mp.setattr(pwarp, "MASK_THRESHOLD", RELAXED_THRESHOLD)
        for pad in (None, 64):
            port = NetEvalModel(model, pad_to_multiple=pad)
            ref = JaxNetEvalModel(jmodel, params, pad_to_multiple=pad)
            flows = [m.eval_forward(*sample[:3]) for m in (port, ref)]
            results = [mod.EvaluationBench([mod.EvalSample(*sample)])(m)
                       for mod, m in ((pbench, port), (jbench, ref))]
            out[pad] = tuple(flows) + tuple(results)
    return out


@pytest.mark.parametrize("pad", [None, 64])
def test_net_eval_model_matches_jax(eval_flows, pad):
    flow, ref, res, ref_res = eval_flows[pad]
    assert isinstance(flow, np.ndarray) and flow.dtype == np.float32
    assert flow.shape == np.asarray(ref).shape == (1, 72, 104, 2)
    err = np.abs(flow - np.asarray(ref))
    assert err.max() <= BAR, "max %.3e mean %.3e" % (err.max(), err.mean())
    np.testing.assert_allclose(res, ref_res, rtol=0, atol=BAR)
    assert 0.0 < res.epe_all < 5.0


def test_net_eval_model_padding_changes_the_border_only(eval_flows):
    """Padded and native-size evaluation differ (the padded border feeds
    the pyramid), most near the padded edges."""
    native, padded = eval_flows[None][0], eval_flows[64][0]
    diff = np.abs(native - padded)
    assert diff.max() > 0.0
    assert diff[:, :48, :80].mean() < diff.mean()


def test_net_eval_model_change_params():
    """``change_params`` loads a state dict into the served model."""
    model = entry.build_model(UPFlowConfig().updated(SGU_KNOBS),
                              device="cpu", seed=1)
    snapshot = entry.build_model(UPFlowConfig().updated(SGU_KNOBS),
                                 device="cpu", weights=NPZ).state_dict()
    eval_model = NetEvalModel(model)
    eval_model.change_params(snapshot)
    for key, value in snapshot.items():
        assert np.array_equal(model.state_dict()[key].numpy(), value.numpy())
    with pytest.raises(RuntimeError):
        eval_model.change_params({"not_a_key": snapshot[next(iter(snapshot))]})
