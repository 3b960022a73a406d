"""The PyTorch port's forward against the JAX ``forward``, on the CPU, and
the port's isolation from JAX.

Both packages get the checkpoint weights (``assets/synthetic_trained.npz``)
and the same numpy images.  The mask threshold is 0.9999 on both sides, as
in ``test_torch_parity.py``: the reference's ``>= 1.0`` bit depends on the
last ulp of the flow, which two conv stacks never reproduce alike.
"""

import ast
import pkgutil
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

import upflow_pytorch_tpu_torch
import upflow_pytorch_tpu_torch.ops.warp as pwarp
from upflow_pytorch_tpu_torch.config import UPFlowConfig
from upflow_pytorch_tpu_torch.models import entry
from upflow_pytorch_tpu_torch.models import upflow as pupflow
from upflow_pytorch_tpu_torch.ops import correlation as pcorr
from upflow_pytorch_tpu_torch.ops.kernels import corr_norm as pcn
from upflow_pytorch_tpu_torch.ops.kernels import feature_warp as pfw
from upflow_pytorch_tpu_torch.ops.kernels import warp as pkw

ROOT = Path(__file__).resolve().parents[1]
NPZ = str(ROOT / "assets" / "synthetic_trained.npz")
SLICE_KNOBS = dict(if_norm_before_cost_volume=True,
                   norm_moments_across_channels=False,
                   norm_moments_across_images=False,
                   if_sgu_upsample=False, if_use_cor_pytorch=False)
RELAXED_THRESHOLD = 0.9999
# (knobs, (batch, height, width)): aligned, ragged, and the unfused
# correlation knob
CASES = [(SLICE_KNOBS, (2, 64, 128)),
         (SLICE_KNOBS, (1, 72, 104)),
         (dict(SLICE_KNOBS, if_use_cor_pytorch=True), (1, 64, 96))]


def _images(b, h, w, seed):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, h, w, 3).astype(np.float32),
            rng.rand(b, h, w, 3).astype(np.float32))


@pytest.fixture(scope="module")
def jax_params():
    """The checkpoint as a flax tree, without the SGU weights."""
    with np.load(NPZ) as z:
        flat = {tuple(k.split("/")): z[k] for k in z.files
                if "/sgu_" not in k}
    return flax.traverse_util.unflatten_dict(flat)


@pytest.fixture(scope="module")
def outputs(jax_params):
    """Both packages' forward outputs for every case, at the relaxed
    threshold."""
    results = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwarp, "MASK_THRESHOLD", RELAXED_THRESHOLD)
        mp.setattr(pwarp, "MASK_THRESHOLD", RELAXED_THRESHOLD)
        for knobs, (b, h, w) in CASES:
            im1, im2 = _images(b, h, w, seed=h + w)
            jmodel = jupflow.build_model(JaxConfig().updated(knobs))
            ref = jax.jit(lambda p, a, c: jupflow.forward(jmodel, p, a, c))(
                jax_params, jnp.asarray(im1), jnp.asarray(im2))
            ref = jax.tree_util.tree_map(np.asarray, ref)
            model = entry.build_model(UPFlowConfig().updated(knobs),
                                      device="cpu", weights=NPZ)
            out = entry.forward(model, im1, im2)
            results.append((ref, out))
    return results


def _max_err(out: torch.Tensor, ref: np.ndarray) -> float:
    assert tuple(out.shape) == ref.shape
    return float(np.abs(out.numpy() - ref).max())


@pytest.mark.parametrize("case", range(len(CASES)))
def test_forward_matches_jax(outputs, case):
    ref, out = outputs[case]
    b, h, w = CASES[case][1]
    for key in ("flow_f_out", "flow_b_out"):
        assert out[key].shape == (b, h, w, 2)
        assert torch.isfinite(out[key]).all()
        err = _max_err(out[key], ref[key])
        assert err <= 1e-4, "%s max err %.3e" % (key, err)
    for key in ("occ_fw", "occ_bw"):
        assert out[key].shape == (b, h, w, 1)
        frac = float(np.mean(out[key].numpy() != ref[key]))
        assert frac < 1e-3, "%s disagree on %.4f of pixels" % (key, frac)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_per_level_flows_match_jax(outputs, case):
    ref, out = outputs[case]
    assert len(out["flows"]) == len(ref["flows"]) == 5
    for i, ((pf, pb), (rf, rb)) in enumerate(zip(out["flows"],
                                                 ref["flows"])):
        ef, eb = _max_err(pf, rf), _max_err(pb, rb)
        assert ef <= 1e-4 and eb <= 1e-4, \
            "level %d (finest-first): fwd %.3e bwd %.3e" % (i, ef, eb)


def test_forward_flows_are_not_trivial(outputs):
    """The checkpoint's flows are non-zero, so the parity bars bite."""
    ref, out = outputs[0]
    assert float(np.abs(ref["flow_f_out"]).mean()) > 0.1
    assert 0.0 < float(out["occ_fw"].mean()) <= 1.0


def test_forward_runs_plain_versions_only_on_the_cpu(outputs):
    """The CPU forward launched no kernel and called no plain version on a
    CUDA tensor."""
    assert (pcorr.correlation.launches, pfw.feature_warp.launches,
            pcn.corr_norm.launches, pkw.warp.launches) == (0, 0, 0, 0)
    assert all(f.cuda_calls == 0 for f in (
        pcorr.correlation_plain, pfw.feature_warp_plain,
        pcn.corr_norm_plain, pkw.warp_plain))


@pytest.mark.parametrize("dtype,error", [
    ("float16", ValueError), ("float64", ValueError),
    ("bfloat16", None)])
def test_unported_knobs_raise(dtype, error):
    """``compute_dtype`` takes "float32" or "bfloat16"; anything else
    raises, naming both.  bf16 builds, with fp32 parameters."""
    if error is not None:
        with pytest.raises(error, match="compute_dtype") as e:
            pupflow.UPFlowNet(UPFlowConfig().updated(
                dict(compute_dtype=dtype)))
        assert "'float32'" in str(e.value) and "'bfloat16'" in str(e.value)
        return
    model = pupflow.UPFlowNet(UPFlowConfig().updated(
        dict(compute_dtype=dtype)))
    assert model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_build_model_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry.build_model(UPFlowConfig())


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        upflow_pytorch_tpu_torch.__path__, "upflow_pytorch_tpu_torch."))


def test_port_imports_no_jax_at_run_time():
    """A fresh interpreter imports every module of the port and finds
    neither JAX nor the JAX package loaded."""
    mods = _port_modules()
    assert len(mods) >= 15
    code = ("import importlib, sys\n"
            "for m in %r: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'upflow_pytorch_tpu'))\n"
            "assert not bad, bad\n" % (mods,))
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_port_sources_import_no_jax():
    """No import statement of the port, of chip_smoke.py or of the port's
    scripts names JAX, flax or the JAX package; the exceptions are the
    scripts that run the JAX package as a reference: the two that write
    the files chip_smoke.py reads, torch_eval_jax_reference.py and
    torch_kitti_jax_reference.py, and torch_kitti_finetune_jax_reference.py,
    which holds the KITTI fine-tune against the JAX package's."""
    files = sorted((ROOT / "upflow_pytorch_tpu_torch").rglob("*.py"))
    for name in ("demo", "data/native", "data/kitti", "data/sintel",
                 "data/image_io", "data/flow_io", "utils/debug",
                 "utils/profiling", "utils/misc", "utils/viz",
                 "parallel/mesh", "parallel/reduce", "parallel/step",
                 "parallel/dryrun"):
        assert ROOT / "upflow_pytorch_tpu_torch" / (name + ".py") in files
    files.append(ROOT / "chip_smoke.py")
    scripts = sorted((ROOT / "scripts").glob("torch_*.py"))
    for name in ("train_synthetic", "kitti_eval", "train_kitti",
                 "train_sintel", "synthetic_trees"):
        assert ROOT / "scripts" / ("torch_%s.py" % name) in scripts
    files += [p for p in scripts if p.name not in (
        "torch_eval_jax_reference.py", "torch_kitti_jax_reference.py",
        "torch_kitti_finetune_jax_reference.py")]
    banned = ("jax", "jaxlib", "flax", "upflow_pytorch_tpu")
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, (path, name)


def _set_high_legacy():
    torch.set_float32_matmul_precision("high")


def _set_tf32_per_backend():
    torch.backends.cuda.matmul.fp32_precision = "tf32"


def _caller_setting():
    """What a caller reads back: the per-backend setting and, where the
    caller's API leaves it readable, the legacy one."""
    try:
        legacy = torch.get_float32_matmul_precision()
    except RuntimeError:  # unreadable once the per-backend API was used
        legacy = None
    return torch.backends.cuda.matmul.fp32_precision, legacy


@pytest.mark.parametrize("set_tf32", [_set_high_legacy,
                                      _set_tf32_per_backend],
                         ids=["legacy-high", "per-backend-tf32"])
def test_forward_pins_full_fp32_matmuls(set_tf32, monkeypatch):
    """A caller's TF32 request does not reach the flow resizes: inside
    ``forward`` every resize sees "highest", afterwards the caller's
    setting reads as before, and the flows equal those of a forward under
    "highest" bit for bit."""
    import upflow_pytorch_tpu_torch.ops.resize as presize

    model = entry.build_model(UPFlowConfig().updated(SLICE_KNOBS),
                              device="cpu", weights=NPZ)
    im1, im2 = _images(1, 64, 128, seed=5)
    want = entry.forward(model, im1, im2)
    seen = []
    resize = presize.resize_bilinear_align_corners

    def spy(x, out_hw, cols=None):
        seen.append((torch.get_float32_matmul_precision(),
                     torch.backends.cuda.matmul.fp32_precision))
        return resize(x, out_hw, cols)

    monkeypatch.setattr(presize, "resize_bilinear_align_corners", spy)
    saved = (torch.backends.cuda.matmul.fp32_precision,
             torch.backends.mkldnn.matmul.fp32_precision)
    try:
        set_tf32()
        before = _caller_setting()
        assert before[0] == "tf32"
        got = entry.forward(model, im1, im2)
        assert _caller_setting() == before
    finally:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.fp32_precision = saved[0]
        torch.backends.mkldnn.matmul.fp32_precision = saved[1]
    assert torch.get_float32_matmul_precision() == "highest"
    assert len(seen) >= 10
    assert all(legacy == "highest" and backend in ("ieee", "none")
               for legacy, backend in seen)
    for key in ("flow_f_out", "flow_b_out", "occ_fw", "occ_bw"):
        assert torch.equal(got[key], want[key]), key
    assert all(torch.equal(a, b) for pair, ref in zip(got["flows"],
                                                      want["flows"])
               for a, b in zip(pair, ref))
