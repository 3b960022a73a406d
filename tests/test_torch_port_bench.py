"""The port's bench (``upflow_pytorch_tpu_torch/bench.py``) and its batch
sweep (``scripts/torch_bench_batch_sweep.py``) on the CPU, at small sizes.

The bench's accuracy fields and its A/B and floor means are held against
the JAX package's ``bench.py`` expressions in ``jax.numpy`` on the same
numpy flows; its fp32 EPE at 64x128 against the JAX package's fp32 oracle
forward on the same pairs (both at mask threshold 0.9999, as the port's
model tests run them).  The timing helpers run on a fake clock.  Every
test runs on one thread (the bench's many small ops stall on descheduled
threads of a loaded machine), and ``main``'s train lane on 64x128 crops
of 96x160 pairs in place of 256x832 of 320x896.
"""

import importlib.util
import json
import subprocess
import sys
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
from upflow_pytorch_tpu_torch import bench
from upflow_pytorch_tpu_torch.data.synthetic import make_dataset

ROOT = Path(__file__).resolve().parents[1]
NPZ = str(ROOT / "assets" / "synthetic_trained.npz")
RELAXED_THRESHOLD = 0.9999
FIELD_TOL = 1e-6
ORACLE_BAR = 1e-3  # px, the port's fp32 EPE against the JAX oracle's
HW = (64, 128)
# the JAX bench's JSON keys less "degraded", and the port's additions
JAX_KEYS = ("metric", "value", "unit", "vs_baseline",
            "sgu_fallback_pairs_per_sec", "loop_dispatch_overhead_s",
            "weights", "epe_vs_gt_bf16_px", "epe_vs_gt_fp32_px",
            "bf16_vs_fp32_mean_epe_px", "bf16_vs_fp32_frac_gt_1px",
            "bf16_vs_fp32_max_epe_px", "fused_on_off_fp32_mean_epe_px",
            "chaos_floor_fp32_mean_epe_px",
            "train_pairs_per_sec_fp32_256x832")
ADDED_KEYS = ("device", "power_limit", "batch", "hw", "iters",
              "sgu_fallback_head_scale", "sgu_fallback_median_inter_flow_px")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sweep_module():
    spec = importlib.util.spec_from_file_location(
        "torch_bench_batch_sweep",
        ROOT / "scripts" / "torch_bench_batch_sweep.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _flows(seed, b=2, h=40, w=56):
    """Three NHWC flows near each other, as a bf16, fp32 and true flow."""
    rng = np.random.RandomState(seed)
    base = rng.randn(b, h, w, 2).astype(np.float32) * 3
    return [base + rng.randn(b, h, w, 2).astype(np.float32) * s
            for s in (0.6, 0.3, 0.5)]


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _jax_flows_pair(f16, f32, gt):
    """``bench.py:263-276``'s expressions on NHWC flows."""
    f16, f32, gt = map(jnp.asarray, (f16, f32, gt))
    d = jnp.linalg.norm(f16 - f32, axis=-1)
    e16 = jnp.linalg.norm(f16 - gt, axis=-1)[:, 8:-8, 8:-8]
    e32 = jnp.linalg.norm(f32 - gt, axis=-1)[:, 8:-8, 8:-8]
    return (jnp.mean(d), jnp.mean(d > 1.0), jnp.max(d), jnp.mean(e16),
            jnp.mean(e32))


def test_accuracy_fields_match_jax_expressions():
    f16, f32, gt = _flows(0)
    got = bench.accuracy_fields(_nchw(f16), _nchw(f32), _nchw(gt))
    mean_e, frac_gt1, max_e, epe16, epe32 = _jax_flows_pair(f16, f32, gt)
    want = {"bf16_vs_fp32_mean_epe_px": mean_e,
            "bf16_vs_fp32_frac_gt_1px": frac_gt1,
            "bf16_vs_fp32_max_epe_px": max_e,
            "epe_vs_gt_bf16_px": epe16, "epe_vs_gt_fp32_px": epe32}
    assert set(got) == set(want)
    assert 0.05 < float(frac_gt1) < 0.95  # both sides of the 1-px bar
    for key, value in want.items():
        assert abs(got[key] - float(value)) <= FIELD_TOL, key


def test_ab_fields_match_jax_expressions():
    """``bench.py:339-340``: the A/B's and the chaos floor's mean EPE."""
    on, off, perturbed = _flows(1)
    got = bench.ab_fields(_nchw(on), _nchw(off), _nchw(perturbed))
    jon = jnp.asarray(on)
    want = {"fused_on_off_fp32_mean_epe_px": jnp.mean(
                jnp.linalg.norm(jon - jnp.asarray(off), axis=-1)),
            "chaos_floor_fp32_mean_epe_px": jnp.mean(
                jnp.linalg.norm(jon - jnp.asarray(perturbed), axis=-1))}
    assert set(got) == set(want)
    for key, value in want.items():
        assert abs(got[key] - float(value)) <= FIELD_TOL, key


def test_main_prints_one_line_with_every_key_on_cpu(capsys, monkeypatch):
    monkeypatch.setattr(bench, "TRAIN_CROP_HW", HW)
    monkeypatch.setattr(bench, "TRAIN_RAW_HW", (96, 160))
    result = bench.main(["--device", "cpu", "--size", "64x128", "--batch",
                         "1", "--iters", "2", "--train-iters", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == json.loads(json.dumps(result))
    for key in JAX_KEYS + ADDED_KEYS:
        assert key in line, key
    assert "degraded" not in line
    assert line["device"] == "cpu" and line["power_limit"] is None
    assert line["unit"] == "pairs/sec/cpu"
    assert line["batch"] == 1 and line["hw"] == [64, 128]
    assert line["iters"] == 2 and line["weights"] == "synthetic_trained"
    for key, value in line.items():
        if isinstance(value, float):
            assert np.isfinite(value), key
    for key in ("value", "sgu_fallback_pairs_per_sec",
                "train_pairs_per_sec_fp32_256x832"):
        assert line[key] > 0, key
    assert line["sgu_fallback_median_inter_flow_px"] > bench.SGU_HALO_PX
    # on the CPU both sides of the A/B run the plain feature warp
    assert line["fused_on_off_fp32_mean_epe_px"] == 0.0


def test_fp32_epe_matches_jax_oracle():
    """``epe_vs_gt_fp32_px`` at 64x128 against the JAX package's fp32
    oracle (``conf_fp32``, its forward on the CPU) on the same pairs."""
    data = make_dataset(1, seed=7, raw_hw=HW, crop_hw=HW)
    with np.load(NPZ) as z:
        params = flax.traverse_util.unflatten_dict(
            {tuple(k.split("/")): z[k] for k in z.files})
    knobs = dict(bench._EVAL, if_use_cor_pytorch=True)
    assert bench.CONF_FP32 == bench.CONF_FP32.updated(knobs)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwarp, "MASK_THRESHOLD", RELAXED_THRESHOLD)
        mp.setattr(pwarp, "MASK_THRESHOLD", RELAXED_THRESHOLD)
        jmodel = jupflow.build_model(JaxConfig().updated(knobs))
        ref = jax.jit(lambda p, a, c: jmodel.apply(p, a, c)[0])(
            params, jnp.asarray(data["im1"]), jnp.asarray(data["im2"]))
        model, used_ckpt = bench.load_model(bench.CONF_FP32, "cpu")
        f32 = bench.forward_flow(model, bench.as_nchw(data["im1"], "cpu"),
                                 bench.as_nchw(data["im2"], "cpu"))
    assert used_ckpt
    gt = data["gt_flow"]
    jax_epe = float(_jax_flows_pair(ref, ref, gt)[4])
    port_epe = bench.accuracy_fields(f32, f32, _nchw(gt))[
        "epe_vs_gt_fp32_px"]
    assert abs(port_epe - jax_epe) <= ORACLE_BAR, (port_epe, jax_epe)


class FakeClock:
    """A clock that reads ``walls[i]`` seconds across the i-th call."""

    def __init__(self, walls):
        self.walls, self.now, self.calls = list(walls), 0.0, 0

    def __call__(self):
        if self.calls % 2:
            self.now += self.walls[self.calls // 2]
        self.calls += 1
        return self.now


@pytest.mark.parametrize("overhead, want", [(0.0, 2.0), (0.5, 1.5),
                                            (5.0, 1e-9)])
def test_measure_takes_the_median_less_the_overhead(overhead, want):
    """The warm-up call is not timed, the median of ``TIMED_RUNS`` is, and
    the overhead comes off it with the 1e-9 floor; each call gets its
    own salt."""
    salts = []
    clock = FakeClock([100.0, 3.0, 1.0, 2.0])
    got = bench._measure(lambda salt: salts.append(salt) or 0.0, overhead,
                         clock)
    assert got == pytest.approx(want, abs=1e-15)
    assert len(salts) == 1 + bench.TIMED_RUNS == len(set(salts))
    first, times = bench.timed_runs(lambda salt: 0.0,
                                    FakeClock([100.0, 3.0, 1.0, 2.0]))
    assert first == 100.0 and times == [3.0, 1.0, 2.0]


def test_chained_loop_feeds_each_forward_the_last_sum():
    """Two chained forwards: the second reads im1 moved by the first's
    flow sums, and the run returns the running sum."""
    model, _ = bench.load_model(bench.CONF_AB, "cpu")
    data = make_dataset(1, seed=3, raw_hw=(32, 64), crop_hw=(32, 64))
    im1, im2 = (bench.as_nchw(data[k], "cpu") for k in ("im1", "im2"))
    got = bench.chained_loop(model, im1, im2, 2)(5.0)
    base = im1 + 5.0 * 1e-9
    acc = torch.zeros(())
    inputs = []
    with torch.no_grad(), bench.fp32_numerics():
        for _ in range(2):
            inputs.append(bench.chain_input(base, acc))
            flow_f, flow_b, _ = model(inputs[-1], im2)
            acc = acc + flow_f.sum() + flow_b.sum()
    assert got == float(acc)
    assert torch.equal(inputs[0], base)
    assert torch.allclose(inputs[1], base + (acc - flow_f.sum()
                                             - flow_b.sum()) * 1e-12)
    assert not torch.equal(inputs[1], base)
    assert bench.noop_loop("cpu", 3)(2.0) == pytest.approx(6e-9)


def test_scale_beyond_halo_is_the_least_power_of_two():
    model, _ = bench.load_model(bench.CONF_AB, "cpu")
    data = make_dataset(1, seed=7, raw_hw=HW, crop_hw=HW)
    im1, im2 = (bench.as_nchw(data[k], "cpu") for k in ("im1", "im2"))
    start = bench.final_inter_flow_px(model, im1, im2)
    scale, median = bench.scale_beyond_halo(model, im1, im2)
    assert start <= bench.SGU_HALO_PX < median
    assert scale > 1 and np.log2(scale) == int(np.log2(scale))
    assert bench.final_inter_flow_px(model, im1, im2) == median
    with torch.no_grad():
        bench.sgu_head_weight(model).mul_(0.5)
    assert bench.final_inter_flow_px(model, im1, im2) <= bench.SGU_HALO_PX


def test_sweep_prints_a_line_a_batch_and_the_summary(capsys):
    summary = _sweep_module().main(["batches=1,2", "iters=1", "h=64",
                                    "w=128", "--device", "cpu"])
    lines = [json.loads(x)
             for x in capsys.readouterr().out.strip().splitlines()]
    assert [x["batch"] for x in lines[:-1]] == [1, 2]
    for line in lines[:-1]:
        assert line["pairs_per_sec"] > 0 and line["ms_per_batch"] > 0
        assert line["compile_s"] > 0 and line["peak_memory_gib"] is None
    assert lines[-1] == json.loads(json.dumps(summary))
    assert summary["best_batch"] in (1, 2)
    assert summary["sweep"][summary["best_batch"]] == max(
        summary["sweep"].values())
    assert summary["weights"] == "ckpt" and summary["device"] == "cpu"


@pytest.mark.parametrize("n_pairs,seed,hw,raw_hw", [
    (3, 7, (32, 64), None), (2, 11, (24, 48), (32, 64))])
def test_render_pairs_are_make_datasets_arrays(n_pairs, seed, hw, raw_hw):
    """The bench's threaded render gives ``make_dataset``'s arrays."""
    got = bench.render_pairs(n_pairs, seed, hw, raw_hw)
    want = make_dataset(n_pairs, seed=seed, raw_hw=raw_hw or hw, crop_hw=hw)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("entry", ["bench", "sweep"])
def test_entry_points_need_the_card(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = bench.main if entry == "bench" else _sweep_module().main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([])


def test_bench_imports_no_jax():
    """A fresh interpreter that imports the bench, the sweep script and
    the setup-time script finds neither JAX nor the JAX package loaded."""
    code = ("import runpy, sys\n"
            "import upflow_pytorch_tpu_torch.bench\n"
            "runpy.run_path('scripts/torch_bench_batch_sweep.py')\n"
            "runpy.run_path('scripts/torch_bench_setup_time.py')\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'upflow_pytorch_tpu'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
