"""The port's utilities against the JAX package's, on the CPU: flow
visualisation, the misc helpers, the debug helpers (``count_params`` of
the SGU model) and the profiling hooks.  Inputs come from numpy seeds."""

import os
import pickle
import zipfile
from pathlib import Path

import flax
import numpy as np
import pytest
import torch

from upflow_pytorch_tpu.utils import debug as jdebug
from upflow_pytorch_tpu.utils import misc as jmisc
from upflow_pytorch_tpu.utils import viz as jviz

from upflow_pytorch_tpu_torch.config import UPFlowConfig
from upflow_pytorch_tpu_torch.models import entry
from upflow_pytorch_tpu_torch.utils import debug, misc, profiling, viz

ROOT = Path(__file__).resolve().parents[1]
NPZ = ROOT / "assets" / "synthetic_trained.npz"
SGU_PARAMS = 3494549


def _flow(seed, h=23, w=37, scale=8.0):
    return (np.random.RandomState(seed).randn(h, w, 2) * scale
            ).astype(np.float32)


def test_color_wheel_equals_jax():
    got = viz.make_color_wheel()
    assert got.shape == (55, 3)
    assert np.array_equal(got, jviz.make_color_wheel())


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_rad", [None, 5.0])
def test_flow_to_image_equals_jax(seed, max_rad):
    flow = _flow(seed)
    flow[0, 0] = 2e7  # unknown flow
    got = viz.flow_to_image(flow, max_rad)
    assert got.dtype == np.uint8 and got.shape == (23, 37, 3)
    assert np.array_equal(got, jviz.flow_to_image(flow, max_rad))


@pytest.mark.parametrize("seed", [0, 3])
def test_error_image_and_arrows_equal_jax(seed):
    gt, pred = _flow(seed), _flow(seed + 10, scale=2.0) + _flow(seed)
    mask = (np.random.RandomState(seed).rand(23, 37, 1) > 0.3)
    got = viz.flow_error_image(gt, pred, mask)
    assert np.array_equal(got, jviz.flow_error_image(gt, pred, mask))
    assert (got[~mask[..., 0]] == 0).all()
    img = np.random.RandomState(seed).randint(0, 256, (23, 37, 3), np.uint8)
    assert np.array_equal(viz.overlay_arrows(img, gt, 8),
                          jviz.overlay_arrows(img, gt, 8))


@pytest.mark.parametrize("seed", [0, 1])
def test_misc_helpers_equal_jax(tmp_path, seed):
    img = np.random.RandomState(seed).randn(7, 9, 3)
    assert np.array_equal(misc.im_norm(img), jmisc.im_norm(img))
    assert np.array_equal(misc.im_norm(np.ones((2, 2))),
                          jmisc.im_norm(np.ones((2, 2))))
    d = misc.check_dir(str(tmp_path / "a" / "b"))
    assert os.path.isdir(d) and d == jmisc.check_dir(d)
    obj = {"x": [1, 2.5], "y": img}
    misc.save_pickle(obj, str(tmp_path / "p.pkl"))
    ref = jmisc.load_pickle(str(tmp_path / "p.pkl"))
    got = misc.load_pickle(str(tmp_path / "p.pkl"))
    assert got["x"] == ref["x"] and np.array_equal(got["y"], ref["y"])
    with open(tmp_path / "p.pkl", "rb") as f:
        assert pickle.load(f)["x"] == [1, 2.5]
    misc.save_npz(str(tmp_path / "a.npz"), a=img)
    with np.load(tmp_path / "a.npz") as z:
        assert np.array_equal(z["a"], img)
    with zipfile.ZipFile(tmp_path / "z.zip", "w") as zf:
        zf.writestr("in/f.txt", "hello")
    misc.extract_zip(str(tmp_path / "z.zip"), str(tmp_path / "out"))
    assert (tmp_path / "out" / "in" / "f.txt").read_text() == "hello"


def test_to_device_batch():
    batch = {"im1": np.arange(6, dtype=np.float32).reshape(2, 3)[:, ::-1],
             "start": [np.float32(2.0), (np.arange(3),)]}
    got = misc.to_device_batch(batch, "cpu")
    assert isinstance(got["im1"], torch.Tensor)
    assert np.array_equal(got["im1"].numpy(), batch["im1"])
    assert got["start"][0].shape == () and float(got["start"][0]) == 2.0
    assert isinstance(got["start"][1], tuple)
    assert np.array_equal(got["start"][1][0].numpy(), np.arange(3))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            misc.to_device_batch(batch)


@pytest.mark.parametrize("seed", [0, 1])
def test_check_tensor_equals_jax(seed, capsys):
    x = np.random.RandomState(seed).randn(3, 4, 5).astype(np.float32)
    ref = jdebug.check_tensor(x, "x")
    assert debug.check_tensor(x, "x") == ref
    assert debug.check_tensor(torch.from_numpy(x), "x") == ref
    assert "dtype=bfloat16" in debug.check_tensor(
        torch.from_numpy(x).bfloat16(), "x")
    assert capsys.readouterr().out.count("x shape=(3, 4, 5)") == 4


def test_count_params_of_the_sgu_model():
    """3,494,549 parameters, as the JAX package counts over the trained
    snapshot's tree; the same over the model and its state dict."""
    model = entry.build_model(UPFlowConfig().updated(
        dict(if_sgu_upsample=True)), device="cpu")
    with np.load(NPZ) as z:
        params = flax.traverse_util.unflatten_dict(
            {tuple(k.split("/")): z[k] for k in z.files})
    assert debug.count_params(model) == SGU_PARAMS
    assert debug.count_params(model.state_dict()) == SGU_PARAMS
    assert jdebug.count_params(params) == SGU_PARAMS


def test_flop_counts_of_a_conv():
    conv = torch.nn.Conv2d(8, 16, 3, padding=1)
    x = torch.randn(2, 8, 12, 20)
    want = 2.0 * 2 * 16 * 8 * 9 * 12 * 20
    assert debug.cost_analysis(conv, x) == {"flops": want,
                                            "bytes_accessed": None}
    assert profiling.flops_of(conv, x) == want
    assert profiling.flops_of(torch.relu, x) is None


def test_nan_debugging_turns_on_anomaly_mode():
    before = torch.is_anomaly_enabled()
    try:
        debug.enable_nan_debugging()
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(before)


def test_profiling_trace_and_timing(tmp_path):
    conv = torch.nn.Conv2d(3, 4, 3)
    x = torch.randn(1, 3, 16, 16)
    with profiling.trace(str(tmp_path / "tr")) as prof:
        conv(x)
    assert prof.key_averages()
    text = (tmp_path / "tr" / profiling.TRACE_FILE).read_text()
    assert "aten::conv2d" in text
    calls = []

    def fn(a):
        calls.append(1)
        return {"y": conv(a)}

    res = profiling.time_jitted(fn, x, iters=5, warmup=2)
    assert len(calls) == 7
    assert sorted(res) == ["best_s", "mean_s", "median_s"]
    assert 0.0 < res["best_s"] <= res["median_s"]
