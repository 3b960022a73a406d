"""Width sharding of the port's eval step (``upflow_pytorch_tpu_torch/
parallel/spatial.py``, the mesh's 'spatial' axis) on the CPU: groups of
2, 3 and 4 real processes over gloo, joined through ``file://`` stores,
each process on one thread with its own timeout, against the unsharded
port in this process and against the JAX package.

What is held, with the values measured when each bar was set:

- the split rule and ``window``: uneven widths, windows across several
  ranks, zero-fill against clip, gather, fp32 and bf16 bit patterns
  (-0.0 included): bit for bit;
- at 2 and 3 ranks each sharded op against the unsharded port op, on
  widths that split unevenly (37 and 19 columns): the masked feature
  warp and its mask (fp32 and bf16 maps), the occlusion check's warp,
  the SGU blend with its mask given, the final SGU stage and the
  bilinear resizes bit for bit; the fp32 and bf16 convs (dilations 1 and
  16, stride 2, 1x1) within ``CONV_BAR`` and one bf16 ulp of max|out|
  (measured 0: bit for bit), the bf16 conv on the route that the whole
  map's shape selects (``conv3x3_seg`` for an 8x300 map, whose own
  columns would take the plain-conv route);
- within a bar of max|out|, because torch's CPU kernels round some
  pixels by where they fall in a map (the tail of a vectorised loop; a
  map's window and the map put other pixels there): the level's SGU
  blend from the raw heads, whose sigmoid differs by an ulp there
  (``SIGMOID_BAR`` 1e-6; measured at most 8.5e-8), the correlation and
  the normalised correlation, whose channel sums do (``CORR_BAR`` 1e-6;
  measured 1.0e-7 and, with the moments, 1.8e-7), the moments and
  ``normalize_features``, summed over the ranks in another order
  (``MOMENT_BAR`` 1e-6 relative; measured 1.1e-7 and 1.4e-7);
- ``tests/test_parallel.py``'s op pipeline (masked warp -> correlation ->
  resize; B=2, 16x64x8, flow +-3 px) sharded in the port against the
  JAX package's ``flow_warp_masked``, ``correlation_xla`` and
  ``resize_bilinear_align_corners`` within that test's 1e-5 (measured
  6.0e-8 at 2 and 3 ranks);
- the sharded eval step from ``assets/synthetic_trained.npz`` on
  synthetic pairs with exact flow at 64x128, SGU, at mask threshold
  0.9999, at data 1 x spatial 2 and data 2 x spatial 2: every rank holds
  the same four outputs bit for bit; against the port's one-process
  ``forward`` at fp32 mean |dflow| < 3e-4 px and p99.9 < 3e-3 px (the
  SGU agreement bars; measured at most 7.9e-7 and 3.6e-6) with no
  occlusion bit apart; at bf16 the bf16 bars, mean < 4e-2 px, p99.9 <
  1.2 px and < 2e-2 of occlusion bits apart (measured at most 2.5e-3,
  3.0e-2 and 3.7e-3: the moments move the affine by an fp32 ulp, the
  cost volume's bf16 rounding turns that into a bf16 ulp on some
  pixels, and at data 2 each row is a B=1 forward against one at B=2);
  at fp32 against the JAX package's ``forward`` within
  ``tests/test_torch_port_sgu_model.py``'s 3e-4 px and 1e-3 of occlusion
  bits (measured 3.0e-5 and 0);
- a frame whose coarsest level is narrower than the ranks raises
  ``ValueError`` naming the level, on every rank;
- the window each conv asks for (``ops/columns.py::conv_window``), and
  the frame's width passed down by the two correlations on windows;
- the dry run's width-sharded rehearsal (``dryrun 2 --device cpu``).
"""

import json
import os
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
from upflow_pytorch_tpu.ops.correlation import correlation_xla
from upflow_pytorch_tpu.ops.resize import (
    resize_bilinear_align_corners as jax_resize)

from upflow_pytorch_tpu_torch.models import entry
from upflow_pytorch_tpu_torch.ops import columns
from upflow_pytorch_tpu_torch.ops.kernels import corr_norm as kcn
from upflow_pytorch_tpu_torch.ops.kernels import correlation as kcorr
from upflow_pytorch_tpu_torch.parallel import dryrun, spatial

ROOT = Path(__file__).resolve().parents[1]
NPZ = str(ROOT / "assets" / "synthetic_trained.npz")
TIMEOUT = 240  # seconds, for every spawned process and its collectives
SIGMOID_BAR = 1e-6
CORR_BAR = 1e-6
MOMENT_BAR = 1e-6
CONV_BAR = 1e-6
BF16_ULP = 2.0 ** -7
JAX_BAR = 3e-4
OUTPUTS = ("flow_f_out", "flow_b_out", "occ_fw", "occ_bw")
# (mean px, p99.9 px, share of occlusion bits apart) against one process
EVAL_BARS = {"float32": (3e-4, 3e-3, 0.0), "bfloat16": (4e-2, 1.2, 2e-2)}

# The jobs: each rank runs them with its shard, and this process runs the
# unsharded ops (``op_results`` without columns) on the same inputs.
_JOBS = r'''
import contextlib
from pathlib import Path

import numpy as np
import torch
import upflow_pytorch_tpu_torch
import upflow_pytorch_tpu_torch.ops.conv as pconv
import upflow_pytorch_tpu_torch.ops.warp as pwarp
from upflow_pytorch_tpu_torch.config import UPFlowConfig
from upflow_pytorch_tpu_torch.data.synthetic import make_dataset
from upflow_pytorch_tpu_torch.models import entry
from upflow_pytorch_tpu_torch.models import upflow
from upflow_pytorch_tpu_torch.models.blocks import ConvBlock
from upflow_pytorch_tpu_torch.ops import resize
from upflow_pytorch_tpu_torch.ops.kernels import corr_norm, feature_warp
from upflow_pytorch_tpu_torch.ops.kernels import sgu_blend, sgu_final
from upflow_pytorch_tpu_torch.ops.normalize import normalize_features
from upflow_pytorch_tpu_torch.parallel import mesh as pmesh
from upflow_pytorch_tpu_torch.parallel import step as pstep
from upflow_pytorch_tpu_torch.parallel.spatial import WidthShard

NPZ = str(Path(upflow_pytorch_tpu_torch.__file__).resolve().parents[1]
          / "assets" / "synthetic_trained.npz")
RELAXED_THRESHOLD = 0.9999
EVAL_KNOBS = dict(if_norm_before_cost_volume=True,
                  norm_moments_across_channels=False,
                  norm_moments_across_images=False, if_sgu_upsample=True,
                  if_use_cor_pytorch=False)
OUTPUTS = ("flow_f_out", "flow_b_out", "occ_fw", "occ_bw")
SPLIT_WIDTHS = (1242, 621, 311, 156, 78, 39, 20, 7, 3)
NORM_KW = dict(normalize=True, center=True, moments_across_channels=False,
               moments_across_images=False)
W, WQ, H = 37, 19, 12  # a map's width, its half, and the rows


def op_inputs():
    """The ops' inputs, from one seed: maps of 37 and 19 columns."""
    rng = np.random.RandomState(7)
    x = rng.randn(2, 3, 4, 23).astype(np.float32)
    x[0, 0, 0, ::3] = -0.0
    return {
        "x": x,
        "x_bf16": torch.from_numpy(x).bfloat16().view(torch.int16).numpy(),
        "fmap": rng.randn(2, 8, H, W).astype(np.float32),
        "flow": ((rng.rand(2, 2, H, W) - 0.5) * 12).astype(np.float32),
        "flow_b": ((rng.rand(2, 2, H, W) - 0.5) * 12).astype(np.float32),
        "head_1": rng.randn(2, 3, H, W).astype(np.float32),
        "head_2": rng.randn(2, 3, H, W).astype(np.float32),
        "mask": rng.rand(2, 1, H, W).astype(np.float32),
        "flow_q": ((rng.rand(2, 2, 6, WQ) - 0.5) * 4).astype(np.float32),
        "head_q": rng.randn(2, 3, 6, WQ).astype(np.float32),
        "f1": rng.randn(2, 16, 5, WQ).astype(np.float32),
        "f2": rng.randn(2, 16, 5, WQ).astype(np.float32),
        "conv_x": rng.randn(1, 16, 10, W).astype(np.float32),
        "seg_x": rng.randn(1, 64, 8, 300).astype(np.float32),
    }


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _blocks():
    g = torch.Generator().manual_seed(5)
    return {"d1": ConvBlock(16, 16, generator=g),
            "d16": ConvBlock(16, 16, dilation=16, generator=g),
            "s2": ConvBlock(16, 32, stride=2, generator=g),
            "k1": ConvBlock(16, 32, kernel_size=1, generator=g),
            "seg": ConvBlock(64, 32, generator=g)}


@contextlib.contextmanager
def count_seg():
    """Counts the bf16 convs that take the conv3x3_seg route."""
    calls = []
    real = pconv.conv3x3_seg

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    pconv.conv3x3_seg = counted
    try:
        yield calls
    finally:
        pconv.conv3x3_seg = real


def op_results(cols_of):
    """Every op on ``op_inputs``; ``cols_of(width)`` gives the Columns of
    a map of that width, or None for the whole map.  Each input is cut to
    the columns it is called on."""
    inp = op_inputs()

    def own(a, width):
        cols = cols_of(width)
        return a if cols is None else a[..., cols.lo:cols.hi]

    def t(name, width, dtype=None):
        return _t(own(inp[name], width), dtype)

    out = {}
    cw, cq = cols_of(W), cols_of(WQ)
    thr = 0.9999
    # the masked feature warp (the map whole, the flow and output own)
    x_src = _t(inp["fmap"]) if cw is None else cw.gather(t("fmap", W))
    x0 = 0 if cw is None else cw.lo
    for dtype in (torch.float32, torch.bfloat16):
        warped, mask = feature_warp.feature_warp(
            x_src.to(dtype), t("flow", W), thr, with_mask=True, x0=x0)
        key = "feature_warp_%s" % str(dtype).split(".")[1]
        out[key] = warped.float().numpy()
        out[key + "_mask"] = mask.numpy()
    out["flow_warp_masked"] = pwarp.flow_warp_masked(
        t("fmap", W), t("flow", W), cw).numpy()
    out["flow_warp"] = pwarp.flow_warp(t("flow_b", W), t("flow", W),
                                       cw).numpy()
    # the blend of a level with its mask given: the flows whole, the
    # inter-flow, the mask and the output own
    f_src = _t(inp["flow"]) if cw is None else cw.gather(t("flow", W))
    out["sgu_blend_masked"] = sgu_blend.sgu_blend_plain(
        f_src, t("head_1", W)[:, :2], t("mask", W), x0).numpy()
    for dtype in (torch.float32, torch.bfloat16):
        pair = pwarp.sgu_blend_pair(
            t("flow", W), t("head_1", W, dtype), t("flow_b", W),
            t("head_2", W, dtype), cw)
        for i, p in enumerate(pair):
            out["sgu_blend_%s_%d" % (str(dtype).split(".")[1], i)] = \
                p.numpy()
    # the final stage: the quarter-resolution flow and head gathered, the
    # output this rank's columns of the (24, 74) frame
    fq, hq = t("flow_q", WQ), t("head_q", WQ)
    if cq is None:
        out["sgu_final"] = sgu_final.sgu_final(fq, hq, (24, 74)).numpy()
    else:
        lo, hi = cq.shard.cols(74)
        out["sgu_final"] = sgu_final.sgu_final(
            cq.gather(fq), cq.gather(hq), (24, 74), lo, hi - lo).numpy()
    out["upsample_flow"] = resize.upsample2d_flow_as(
        t("flow_q", WQ), (H, W), True, cq).numpy()
    out["resize_up"] = resize.resize_bilinear_align_corners(
        t("head_q", WQ), (H, W), cq).numpy()
    out["resize_down"] = resize.resize_bilinear_align_corners(
        t("fmap", W), (6, WQ), cw).numpy()
    out["correlation"] = upflow._correlation(
        t("f1", WQ), t("f2", WQ), 4, cq).numpy()
    out["warp_corr"] = corr_norm.warp_norm_corr(
        t("fmap", W), t("fmap", W).flip(1), t("flow", W), None, 0.1, thr,
        cw).numpy()
    out["warp_norm_corr"] = corr_norm.warp_norm_corr(
        t("fmap", W), t("fmap", W).flip(1), t("flow", W), NORM_KW, 0.1, thr,
        cw).numpy()
    n1, n2 = normalize_features((t("f1", WQ), t("f2", WQ)), **NORM_KW,
                                cols=cq)
    out["normalize_1"], out["normalize_2"] = n1.numpy(), n2.numpy()
    for ac in (False, True):
        m, v = corr_norm.moments(t("fmap", W), ac, cw)
        out["moments_%d" % ac] = torch.stack([m, v]).numpy()
    blocks = _blocks()
    for name in ("d1", "d16", "s2", "k1"):
        out["conv_" + name] = blocks[name](t("conv_x", W),
                                           cols=cw).detach().numpy()
    with torch.no_grad(), count_seg() as calls:
        xs = t("seg_x", 300, torch.bfloat16)
        out["conv_seg"] = blocks["seg"](
            xs, cols=cols_of(300)).float().numpy()
        out["conv_seg_route"] = np.array(len(calls))
        out["conv_bf16_s2"] = blocks["s2"](
            t("conv_x", W, torch.bfloat16), cols=cw).float().numpy()
    return out


def run_ops(job, mesh, shard):
    """The sharded ops, the split rule and the windows on this rank."""
    out = {"split": np.array([shard.cols(w) for w in SPLIT_WIDTHS])}
    out.update(op_results(shard.at))
    inp = op_inputs()
    w = inp["x"].shape[-1]
    lo, hi = shard.cols(w)
    spans = shard.spans(w)
    x = torch.from_numpy(inp["x"][..., lo:hi].copy())
    xb = torch.from_numpy(inp["x_bf16"][..., lo:hi].copy()).view(
        torch.bfloat16)
    far = lambda r: (spans[r][0] - 10, spans[r][1] + 3)
    out["halo_1"] = shard.halo(x, w, 1, 1).numpy()
    out["halo_16"] = shard.halo(x, w, 16, 16).numpy()
    out["far_zero"] = shard.window(x, w, far).numpy()
    out["far_clip"] = shard.window(x, w, far, "clip").numpy()
    out["gather"] = shard.gather(x, w).numpy()
    out["halo_16_bf16"] = shard.halo(xb, w, 16, 16).view(torch.int16).numpy()
    out["gather_bf16"] = shard.gather(xb, w).view(torch.int16).numpy()
    return out


def pipeline_inputs():
    """tests/test_parallel.py::test_spatial_sharding_op_pipeline_exact's
    inputs (NHWC)."""
    rng = np.random.RandomState(2)
    f1 = rng.rand(2, 16, 64, 8).astype(np.float32)
    f2 = rng.rand(2, 16, 64, 8).astype(np.float32)
    flow = ((rng.rand(2, 16, 64, 2) - 0.5) * 6).astype(np.float32)
    return f1, f2, flow


def run_pipeline(job, mesh, shard):
    """That test's pipeline (masked warp -> correlation -> resize to
    32x128) on this rank's columns."""
    cols = shard.at(64)
    f1, f2, flow = (torch.from_numpy(a).permute(0, 3, 1, 2)[
        ..., cols.lo:cols.hi].contiguous() for a in pipeline_inputs())
    warped = pwarp.flow_warp_masked(f2, flow, cols)
    corr = upflow._correlation(f1, warped, 4, cols)
    return {"out": resize.resize_bilinear_align_corners(
        corr, (32, 128), cols).numpy()}


def eval_pairs():
    d = make_dataset(2, seed=3, raw_hw=(80, 150), crop_hw=(64, 128))
    return d["im1"], d["im2"]


@contextlib.contextmanager
def threshold(value):
    saved = pwarp.MASK_THRESHOLD
    pwarp.MASK_THRESHOLD = value
    try:
        yield
    finally:
        pwarp.MASK_THRESHOLD = saved


def eval_model(dtype):
    conf = UPFlowConfig().updated(dict(EVAL_KNOBS, compute_dtype=dtype))
    return entry.build_model(conf, "cpu", weights=NPZ)


def run_eval(job, mesh, shard):
    """The width-sharded eval step at this job's (data, spatial) mesh: the
    four gathered outputs and what this rank moved."""
    im1, im2 = eval_pairs()
    with threshold(job["threshold"]):
        step = pstep.make_sharded_eval_step(eval_model(job["dtype"]), mesh,
                                            spatial=True)
        got = step(im1, im2)
    out = {k: v.numpy() for k, v in zip(OUTPUTS, got)}
    out["bytes"] = np.array(step.shard.bytes_reduced)
    out["collectives"] = np.array(step.shard.collectives)
    return out


def run_narrow(job, mesh, shard):
    """A 64x128 frame over 3 'spatial' ranks: its 1/64 level is 2 wide."""
    im1, im2 = eval_pairs()
    step = pstep.make_sharded_eval_step(eval_model("float32"), mesh,
                                        spatial=True)
    try:
        step(im1, im2)
    except ValueError as e:
        return {"error": np.array(str(e))}
    return {"error": np.array("")}


RUNNERS = {"ops": run_ops, "pipeline": run_pipeline, "eval": run_eval,
           "narrow": run_narrow}
'''

_WORKER = _JOBS + r'''
import datetime
import json
import sys

torch.set_num_threads(1)
rank, world, init_method, spec, timeout = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
    float(sys.argv[5]))
pmesh.init_distributed(rank=rank, world_size=world, init_method=init_method,
                       device="cpu",
                       timeout=datetime.timedelta(seconds=timeout))
try:
    with open(spec) as f:
        jobs = json.load(f)
    for name, job in jobs.items():
        mesh = pmesh.make_mesh(data=job["data"], spatial=job["spatial"],
                               device="cpu")
        shard = WidthShard(mesh.spatial_group, mesh.spatial_rank,
                           mesh.spatial)
        np.savez(job["out"] % rank, **RUNNERS[job["kind"]](job, mesh, shard))
    print("WORKER_DONE", rank, flush=True)
finally:
    pmesh.close_distributed()
'''

# the groups: world size -> jobs ((data, spatial) and what they run)
GROUPS = {
    2: {"ops": dict(kind="ops", data=1, spatial=2),
        "pipeline": dict(kind="pipeline", data=1, spatial=2),
        "eval_fp32": dict(kind="eval", data=1, spatial=2, dtype="float32"),
        "eval_bf16": dict(kind="eval", data=1, spatial=2, dtype="bfloat16")},
    3: {"ops": dict(kind="ops", data=1, spatial=3),
        "pipeline": dict(kind="pipeline", data=1, spatial=3),
        "narrow": dict(kind="narrow", data=1, spatial=3)},
    4: {"eval_fp32": dict(kind="eval", data=2, spatial=2, dtype="float32"),
        "eval_bf16": dict(kind="eval", data=2, spatial=2,
                          dtype="bfloat16")},
}


def _start(tmp, world, jobs):
    for name, job in jobs.items():
        job.setdefault("threshold", 0.9999)
        job["out"] = str(tmp / ("w%d_%s_rank%%d.npz" % (world, name)))
    spec = tmp / ("jobs_%d.json" % world)
    spec.write_text(json.dumps(jobs))
    script = tmp / "worker.py"
    if not script.exists():
        script.write_text(_WORKER)
    init = "file://" + str(tmp / ("store_%d" % world))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    return [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), init, str(spec),
         str(TIMEOUT)], cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]


def _wait(procs):
    try:
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, "rank %d failed:\n%s" % (i, out[-6000:])
        assert "WORKER_DONE" in out
    return outs


@pytest.fixture(scope="module")
def jobs_ns():
    ns = {}
    exec(compile(_JOBS, "_JOBS", "exec"), ns)
    return ns


@pytest.fixture(scope="module")
def groups(tmp_path_factory, jobs_ns):
    """Every group's jobs on its ranks (one output per rank and job) and,
    while they run, the unsharded references in this process: the ops,
    the port's one-process forward at both precisions, the JAX forward
    and the JAX pipeline."""
    tmp = tmp_path_factory.mktemp("spatial")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    procs = {}
    try:
        for world, jobs in GROUPS.items():
            procs[world] = _start(tmp, world, jobs)
        refs = {"ops": jobs_ns["op_results"](lambda width: None)}
        im1, im2 = jobs_ns["eval_pairs"]()
        with jobs_ns["threshold"](jobs_ns["RELAXED_THRESHOLD"]):
            for dtype in EVAL_BARS:
                out = entry.forward(jobs_ns["eval_model"](dtype), im1, im2)
                refs[dtype] = {k: out[k].numpy()
                               for k in jobs_ns["OUTPUTS"]}
        refs["jax"] = _jax_forward(jobs_ns, im1, im2)
        refs["pipeline"] = _jax_pipeline(jobs_ns["pipeline_inputs"]())
        for world in GROUPS:
            _wait(procs.pop(world))
    finally:
        torch.set_num_threads(threads)
        for ps in procs.values():
            for p in ps:
                p.kill()
                p.wait()
    ranks = {}
    for world, jobs in GROUPS.items():
        for name, job in jobs.items():
            ranks[(world, name)] = []
            for r in range(world):
                with np.load(job["out"] % r) as z:
                    ranks[(world, name)].append({k: z[k] for k in z.files})
    return dict(ranks=ranks, refs=refs)


def _jax_forward(ns, im1, im2):
    with np.load(NPZ) as z:
        params = flax.traverse_util.unflatten_dict(
            {tuple(k.split("/")): z[k] for k in z.files})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwarp, "MASK_THRESHOLD", ns["RELAXED_THRESHOLD"])
        model = jupflow.build_model(JaxConfig().updated(ns["EVAL_KNOBS"]))
        out = jax.jit(lambda p, a, b: jupflow.forward(model, p, a, b))(
            params, jnp.asarray(im1), jnp.asarray(im2))
        return {k: np.asarray(out[k]) for k in ns["OUTPUTS"]}


def _jax_pipeline(inputs):
    f1, f2, flow = (jnp.asarray(a) for a in inputs)
    warped = jwarp.flow_warp_masked(f2, flow)
    return np.asarray(jax_resize(correlation_xla(f1, warped), (32, 128)))


def _joined(parts):
    """The ranks' columns of a map, side by side."""
    return np.concatenate(parts, axis=-1)


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


WINDOW_KEYS = ("halo_1", "halo_16", "far_zero", "far_clip", "gather",
               "halo_16_bf16", "gather_bf16")


def _expected_window(x, key, lo, hi, w):
    """Columns of the whole map ``x`` as ``run_ops`` asks for them."""
    left, right = {"halo_1": (1, 1), "halo_16": (16, 16),
                   "halo_16_bf16": (16, 16), "far_zero": (10, 3),
                   "far_clip": (10, 3)}.get(key, (lo, w - hi))
    a, b = lo - left, hi + right
    if key == "far_clip":
        a, b = max(a, 0), min(b, w)
    pad = np.zeros(x.shape[:-1] + (b - a,), x.dtype)
    s, e = max(a, 0), min(b, w)
    pad[..., s - a:e - a] = x[..., s:e]
    return pad


@pytest.mark.parametrize("world", [2, 3])
def test_split_rule_and_windows(groups, jobs_ns, world):
    """Rank s of S owns [floor(s*W/S), floor((s+1)*W/S)) of every width;
    halos, windows across several ranks, zero-fill and clip, and gather
    return the whole map's columns bit for bit, fp32 and bf16 (-0.0
    included)."""
    ranks = groups["ranks"][(world, "ops")]
    inp = jobs_ns["op_inputs"]()
    w = inp["x"].shape[-1]
    for s, r in enumerate(ranks):
        assert r["split"].tolist() == [
            [s * width // world, (s + 1) * width // world]
            for width in jobs_ns["SPLIT_WIDTHS"]]
        lo, hi = s * w // world, (s + 1) * w // world
        for key in WINDOW_KEYS:
            x = inp["x_bf16"] if key.endswith("bf16") else inp["x"]
            want = _expected_window(x, key, lo, hi, w)
            assert r[key].shape == want.shape, key
            assert np.array_equal(_bits(r[key]), _bits(want)), (s, key)
    assert np.signbit(ranks[0]["gather"][0, 0, 0, ::3]).all()


BIT_EXACT = ("feature_warp_float32", "feature_warp_float32_mask",
             "feature_warp_bfloat16", "feature_warp_bfloat16_mask",
             "flow_warp_masked", "flow_warp", "sgu_blend_masked",
             "sgu_final", "upsample_flow", "resize_up", "resize_down")


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("key", BIT_EXACT)
def test_warps_blends_and_resizes_are_bit_exact(groups, world, key):
    """The ranks' columns, side by side, are the unsharded op's output bit
    for bit, mask bits included."""
    ranks = groups["ranks"][(world, "ops")]
    got = _joined([r[key] for r in ranks])
    want = groups["refs"]["ops"][key]
    assert got.shape == want.shape
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("key,bar", [
    ("sgu_blend_float32_0", SIGMOID_BAR),
    ("sgu_blend_float32_1", SIGMOID_BAR),
    ("sgu_blend_bfloat16_0", SIGMOID_BAR),
    ("sgu_blend_bfloat16_1", SIGMOID_BAR),
    ("correlation", CORR_BAR), ("warp_corr", CORR_BAR),
    ("warp_norm_corr", CORR_BAR), ("normalize_1", MOMENT_BAR),
    ("normalize_2", MOMENT_BAR), ("conv_d1", CONV_BAR),
    ("conv_d16", CONV_BAR), ("conv_s2", CONV_BAR), ("conv_k1", CONV_BAR),
    ("conv_seg", BF16_ULP), ("conv_bf16_s2", BF16_ULP)])
def test_convs_moments_and_correlations_within_their_bars(groups, world,
                                                          key, bar):
    """The ranks' columns, side by side, within ``bar`` of max|out| of the
    unsharded op (the module docstring gives each bar's reason)."""
    ranks = groups["ranks"][(world, "ops")]
    got = _joined([r[key] for r in ranks])
    want = groups["refs"]["ops"][key]
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= bar, "%s: %.3e of max|out|" % (key, err)


@pytest.mark.parametrize("world", [2, 3])
def test_moments_are_the_frames(groups, world):
    """Each rank's moments (over its own columns, summed over the ranks)
    are the whole map's within ``MOMENT_BAR`` relative."""
    want = groups["refs"]["ops"]
    for r in groups["ranks"][(world, "ops")]:
        for ac in (0, 1):
            key = "moments_%d" % ac
            err = np.abs(r[key] - want[key]).max() / np.abs(want[key]).max()
            assert err <= MOMENT_BAR, (key, err)


@pytest.mark.parametrize("world", [2, 3])
def test_bf16_convs_take_the_whole_maps_route(groups, world):
    """A 64-channel 3x3 bf16 conv on an 8x300 map runs conv3x3_seg on
    every rank, whose own columns alone (8x100 .. 8x150) would take the
    plain-conv route."""
    for r in groups["ranks"][(world, "ops")]:
        assert int(r["conv_seg_route"]) == 1
    assert int(groups["refs"]["ops"]["conv_seg_route"]) == 1


@pytest.mark.parametrize("world", [2, 3])
def test_op_pipeline_matches_the_jax_package(groups, world):
    """``tests/test_parallel.py``'s warp -> correlation -> resize pipeline,
    width-sharded in the port, against the JAX ops within that test's
    1e-5."""
    got = _joined([r["out"] for r in groups["ranks"][(world, "pipeline")]])
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1),
                               groups["refs"]["pipeline"], rtol=1e-5,
                               atol=1e-5)


def _flow_diffs(a, b):
    d = np.abs(a - b)
    return float(d.mean()), float(np.percentile(d, 99.9))


EVAL_RUNS = [(2, "eval_fp32", "float32"), (2, "eval_bf16", "bfloat16"),
             (4, "eval_fp32", "float32"), (4, "eval_bf16", "bfloat16")]


@pytest.mark.parametrize("world,name,dtype", EVAL_RUNS)
def test_sharded_eval_step_matches_one_process(groups, world, name, dtype):
    """Every rank holds the same four outputs at full width, within the
    path's bars of the port's one-process forward at threshold 0.9999;
    each rank moved bytes."""
    ranks = groups["ranks"][(world, name)]
    ref = groups["refs"][dtype]
    mean_bar, p999_bar, occ_bar = EVAL_BARS[dtype]
    for r in ranks[1:]:
        for key in OUTPUTS:
            assert np.array_equal(_bits(r[key]), _bits(ranks[0][key])), key
    got = ranks[0]
    for key in ("flow_f_out", "flow_b_out"):
        assert got[key].shape == ref[key].shape == (2, 64, 128, 2)
        assert np.isfinite(got[key]).all()
        mean, p999 = _flow_diffs(got[key], ref[key])
        assert mean < mean_bar and p999 < p999_bar, (key, mean, p999)
    for key in ("occ_fw", "occ_bw"):
        share = float(np.mean(got[key] != ref[key]))
        assert share <= occ_bar, (key, share)
    assert all(int(r["bytes"]) > 0 and int(r["collectives"]) > 0
               for r in ranks)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_eval_step_matches_the_jax_forward(groups, world):
    """At fp32 the sharded eval step's flows are within 3e-4 px of the JAX
    package's ``forward`` and its occlusion masks within 1e-3 of the
    pixels (``tests/test_torch_port_sgu_model.py``'s bars)."""
    got = groups["ranks"][(world, "eval_fp32")][0]
    ref = groups["refs"]["jax"]
    for key in ("flow_f_out", "flow_b_out"):
        assert np.abs(got[key] - ref[key]).max() <= JAX_BAR, key
    for key in ("occ_fw", "occ_bw"):
        assert float(np.mean(got[key] != ref[key])) < 1e-3, key


def test_a_frame_too_narrow_for_its_ranks_raises(groups):
    """64x128 over 3 'spatial' ranks: the 1/64 level is 2 columns wide,
    and every rank raises ``ValueError`` naming it."""
    for r in groups["ranks"][(3, "narrow")]:
        assert str(r["error"]) == (
            "pyramid level 1/64 is 2 columns wide: split over 3 ranks it "
            "leaves a rank no column")


def test_window_without_a_group_checks_its_input():
    """``window`` refuses a map that is not the rank's columns and an
    unknown ``outside``, before any collective."""
    shard = spatial.WidthShard(None, 1, 2)
    assert shard.cols(7) == (3, 7)
    with pytest.raises(ValueError, match="holds columns"):
        shard.gather(torch.zeros(1, 3), 7)
    with pytest.raises(ValueError, match="outside"):
        shard.halo(torch.zeros(1, 4), 7, 1, 1, "edge")


class _Requests:
    """A shard stand-in whose ``window`` returns the columns asked for."""

    def __init__(self, rank, size):
        self.rank, self.size = rank, size

    def window(self, x, width, request, outside):
        return request(self.rank)


@pytest.mark.parametrize("conv,want", [
    ((3, 1, 1, 1), (11, 25)),    # a 3x3 conv: one column each side
    ((3, 1, 16, 16), (-4, 40)),  # dilation 16, wider than a shard
    ((3, 2, 1, 1), (11, 24)),    # stride 2: output columns [6, 12) of 19
    ((1, 1, 0, 1), (12, 24)),    # 1x1: the rank's own columns
])
def test_conv_window_asks_for_the_columns_its_outputs_read(conv, want):
    """Rank 1 of 3 on a map 37 columns wide holds [12, 24); a conv (kernel,
    stride, padding, dilation) asks for ``[a*s - p, (b-1)*s - p +
    d*(k-1) + 1)`` of its output columns ``[a, b)``."""
    cols = columns.Columns(_Requests(1, 3), 37)
    assert (cols.lo, cols.hi) == (12, 24)
    assert cols.spans_of(19)[1] == (6, 12)
    assert columns.conv_window(None, cols, *conv) == want


@pytest.mark.parametrize("op", ["correlation", "corr_norm"])
def test_window_correlations_pass_the_frames_width(op, monkeypatch):
    """The two correlations take the frame's width for a window of it, to
    launch on the frame's grid (``correlation.py::launch_tiles``): the
    width reaches the dispatch, and on the CPU the plain version's values
    are those without it."""
    rng = np.random.RandomState(5)
    f1, f2 = (torch.from_numpy(rng.randn(1, 6, 5, 11).astype(np.float32))
              for _ in range(2))
    seen = []
    if op == "correlation":
        inner = kcorr._correlation
        monkeypatch.setattr(kcorr, "_correlation", lambda *a: (
            seen.append(a[-1]), inner(*a))[1])
        got = kcorr.correlation(f1, f2, 4, 37)
        ref = kcorr.correlation(f1, f2)
    else:
        aff = kcn.affine_pair(*kcn.moments(f1, False), *kcn.moments(f2, False),
                              dict(normalize=True, center=True,
                                   moments_across_images=False))
        inner = kcn._corr_norm
        monkeypatch.setattr(kcn, "_corr_norm", lambda *a: (
            seen.append(a[-1]), inner(*a))[1])
        got = kcn.corr_norm(f1, f2, aff, 0.1, 37)
        ref = kcn.corr_norm(f1, f2, aff, 0.1)
    assert seen == [37, None]
    assert torch.equal(got, ref)


def test_dryrun_runs_the_width_sharded_rehearsal(capsys, monkeypatch):
    """``dryrun 2 --device cpu`` prints the step's loss and, after it, the
    width-sharded eval's flow shape, as the JAX dry run does."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    dryrun.main(["2", "--device", "cpu", "--timeout", str(TIMEOUT)])
    out = capsys.readouterr().out
    assert "dryrun_multigpu(2): total_loss=" in out
    assert "dryrun_multigpu: spatial=2 full-model eval ok (1, 64, 128, 2)" \
        in out

