"""The port's data parallelism (``upflow_pytorch_tpu_torch/parallel/``) on
the CPU: two real processes over gloo, joined through a ``file://`` store,
against one process at the global batch, and against the JAX package's
sharded step on a 2-device virtual CPU mesh.

Each rank runs one thread and imports no JAX; every spawned process has
its own timeout.  The step's jobs (``_JOBS``) run the same code in the
ranks and, with no mesh, in this process.  Batches: two synthetic pairs
with exact flow (``data/synthetic.py``) at 32x48, from the trained
snapshot, with the occlusion-masked photometric term
(``photo_loss_use_occ``) and the masked 'upup' distillation, so the
masked normalisers are on the path.

Bars, with the values measured when they were set (2 ranks at B=1 each
against one process at B=2):

- ``LOSS_BAR`` = 1e-3 relative total loss, the JAX bar
  (``tests/test_parallel.py``), on that test's recipe, batch and seeded
  weights at the reference's mask threshold 1.0: measured 3.8e-5;
- ``ROBUST_LOSS_BAR`` = 1e-5 relative for every term of the masked recipe
  from the trained snapshot at threshold 0.9999 (measured at most 3.3e-7
  without and 5.5e-7 with the equivariance pass), and of the dry run
  under ``UPFLOW_ROBUST_MASK`` (1.7e-7);
- gradient cosine >= ``GRAD_COSINE_BAR`` (measured 1 - 6.6e-10 and
  1 - 4.9e-10) and the cosine of the parameters' update >=
  ``UPDATE_COSINE_BAR`` (measured 1 - 3.8e-7 and 1 - 2.3e-5: Adam's first
  step is near the gradient's sign, so tiny components count);
- the sensitivity batch, whose two halves have very different
  visible-pixel sums: per-rank normalisers (each rank's loss over its own
  mask sum, then averaged, as plain ``DistributedDataParallel`` would)
  miss the single process's loss by 2.7e-2 relative, 27x ``LOSS_BAR``,
  where the global normalisers give the same loss (measured 0);
- the 2-rank step against the JAX package's 2-device step (SGU off)
  within ``LOSS_BAR`` (measured 2.0e-7).  Its JAX compile takes about
  95 s on the CPU, so that one test is marked ``slow``;
- the sharded eval step's flow within 1e-4 px of one process's
  (measured 1.7e-6), no occlusion bit apart;
- the ``Trainer`` at data_axis=2 against one process: its first step
  within ``ROBUST_LOSS_BAR`` (measured 1.3e-7), its second within
  ``LOSS_BAR`` (2.4e-6); Adam's sign-like first steps make later steps
  drift apart about 100x a step, so they are held rank to rank only.
"""

import datetime
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import flax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import upflow_pytorch_tpu.ops.warp as jwarp
from upflow_pytorch_tpu.config import TrainerConfig as JaxTrainerConfig
from upflow_pytorch_tpu.config import UPFlowConfig as JaxConfig
from upflow_pytorch_tpu.parallel import mesh as jmesh
from upflow_pytorch_tpu.parallel import step as jpstep
from upflow_pytorch_tpu.train import step as jstep

from upflow_pytorch_tpu_torch.checkpoint import state_io, torch_import
from upflow_pytorch_tpu_torch.config import TrainerConfig, UPFlowConfig
from upflow_pytorch_tpu_torch.data.pipeline import DataLoader
from upflow_pytorch_tpu_torch.data.synthetic import make_dataset
from upflow_pytorch_tpu_torch.models import entry
from upflow_pytorch_tpu_torch.parallel import dryrun, mesh as pmesh, reduce
from upflow_pytorch_tpu_torch.parallel.spatial import WidthShard
from upflow_pytorch_tpu_torch.parallel.step import make_sharded_train_step
from upflow_pytorch_tpu_torch.train import step as pstep
from upflow_pytorch_tpu_torch.train.trainer import Trainer

ROOT = Path(__file__).resolve().parents[1]
NPZ = str(ROOT / "assets" / "synthetic_trained.npz")
sys.path.insert(0, str(ROOT / "scripts"))
import torch_kitti_eval  # noqa: E402
import torch_synthetic_trees as trees  # noqa: E402

TIMEOUT = 240  # seconds, for every spawned process and its collectives
LOSS_BAR = 1e-3
ROBUST_LOSS_BAR = 1e-5
GRAD_COSINE_BAR = 0.9999
UPDATE_COSINE_BAR = 0.999
RELAXED_THRESHOLD = 0.9999
# the trained snapshot's eval recipe with the training losses, masked
KNOBS = dict(if_norm_before_cost_volume=True,
             norm_moments_across_channels=False,
             norm_moments_across_images=False, if_sgu_upsample=True,
             photo_loss_census_weight=1.0, photo_loss_use_occ=True,
             multi_scale_distillation_weight=0.01,
             multi_scale_distillation_style="upup",
             multi_scale_distillation_occ=True, if_use_boundary_warp=True)
# tests/test_trainer_e2e.py's recipe, for the Trainer
TRAINER_KNOBS = dict(if_use_cor_pytorch=True, if_sgu_upsample=False,
                     if_use_boundary_warp=True)
# the same without SGU, against the JAX package's sharded step
JAX_KNOBS = dict(KNOBS, if_sgu_upsample=False, if_use_cor_pytorch=True)
# tests/test_parallel.py's recipe, held at the reference's threshold
PARALLEL_KNOBS = dict(if_norm_before_cost_volume=True,
                      norm_moments_across_channels=False,
                      norm_moments_across_images=False,
                      photo_loss_census_weight=1.0,
                      if_use_boundary_warp=True, if_use_cor_pytorch=True,
                      if_sgu_upsample=False)
SMALL_TREES = dict(KITTI_2015_SIZES=((56, 120),), PAIRS_PER_SIZE=1,
                   TEST_SIZES=((56, 120),), KITTI_2012_SIZE=(56, 120),
                   MV_SIZE=(48, 100), MV_FRAMES=12, SINTEL_SIZE=(52, 90))

# The jobs, run by each rank with its mesh and here with none.
_JOBS = r'''
import contextlib
import numpy as np
import torch
import upflow_pytorch_tpu_torch.ops.warp as pwarp
from upflow_pytorch_tpu_torch.config import TrainerConfig, UPFlowConfig
from upflow_pytorch_tpu_torch.data.pipeline import DataLoader
from upflow_pytorch_tpu_torch.models import entry
from upflow_pytorch_tpu_torch.parallel import mesh as pmesh
from upflow_pytorch_tpu_torch.parallel import step as pstep
from upflow_pytorch_tpu_torch.train import step as tstep


def flat(tensors):
    return torch.cat([t.detach().reshape(-1) for t in tensors]).numpy()


@contextlib.contextmanager
def threshold(value):
    saved = pwarp.MASK_THRESHOLD
    pwarp.MASK_THRESHOLD = value
    try:
        yield
    finally:
        pwarp.MASK_THRESHOLD = saved


@contextlib.contextmanager
def per_rank_normalisers(on):
    """Each rank's loss over its own normalisers (what averaging per-rank
    losses, as plain DDP does, computes)."""
    saved = tstep.global_normalisers
    if on:
        tstep.global_normalisers = lambda mesh: contextlib.nullcontext()
    try:
        yield
    finally:
        tstep.global_normalisers = saved


def run_step(job, mesh):
    conf = UPFlowConfig().updated(job["knobs"])
    batch = dict(np.load(job["batch"]))
    with threshold(job["threshold"]), per_rank_normalisers(
            job.get("per_rank", False)):
        model, state, opt = tstep.create_train_state(
            conf, TrainerConfig(), device="cpu", weights=job["weights"])
        names = sorted(n for n, _ in model.named_parameters())
        params = dict(model.named_parameters())
        if mesh is None:
            step = tstep.make_train_step(model, opt,
                                         eq_loss_weight=job["eq_weight"])
        else:
            pmesh.replicate(mesh, model, opt)
            batch = pmesh.shard_batch(mesh, batch)
            step = pstep.make_sharded_train_step(
                model, opt, mesh, eq_loss_weight=job["eq_weight"])
        before = flat(params[n] for n in names)
        _, metrics = step(state, batch)
    after = flat(params[n] for n in names)
    out = {"params": after, "update": after - before,
           "grads": flat(params[n].grad for n in names)}
    out.update({k: np.float32(v) for k, v in metrics.items()})
    return out


def run_eval(job, mesh):
    conf = UPFlowConfig().updated(job["knobs"])
    batch = dict(np.load(job["batch"]))
    model = entry.build_model(conf, "cpu", weights=job["weights"])
    keys = ("flow_f_out", "flow_b_out", "occ_fw", "occ_bw")
    with threshold(job["threshold"]):
        if mesh is None:
            out = entry.forward(model, batch["im1"], batch["im2"])
            return {k: out[k].numpy() for k in keys}
        got = pstep.make_sharded_eval_step(model, mesh)(batch["im1"],
                                                       batch["im2"])
        rows = mesh.rows(len(batch["im1"]))
        local = entry.forward(model, batch["im1"][rows], batch["im2"][rows])
    out = {k: v.numpy() for k, v in zip(keys, got)}
    out["own_rows_exact"] = np.array(all(
        torch.equal(g[rows], local[k]) for k, g in zip(keys, got)))
    return out


class Items:
    """Ten items keyed on (epoch, index), as an augmented dataset is."""

    def __len__(self):
        return 10

    def item(self, index, epoch=0):
        rng = np.random.RandomState(1000 * epoch + index)
        return {"x": rng.rand(3).astype(np.float32),
                "i": np.array([epoch, index], np.int64)}


def run_loader(job, mesh):
    shard = (0, 1) if mesh is None else (mesh.rank, mesh.size)
    out = {}
    loader = DataLoader(Items(), batch_size=4, num_workers=2, seed=5,
                        shard=shard)
    for i in range(5):  # two batches an epoch: crosses two epoch ends
        for k, v in next(loader).items():
            out["run_%d_%s" % (i, k)] = v
    out["state"] = np.array([loader.state()["epoch"],
                             loader.state()["position"]])
    loader.close()
    resumed = DataLoader(Items(), batch_size=4, num_workers=2, seed=5,
                         shard=shard)
    resumed.set_cursor(1, 1)
    for i in range(3):
        for k, v in next(resumed).items():
            out["resumed_%d_%s" % (i, k)] = v
    resumed.close()
    return out


class Pairs:
    """tests/test_trainer_e2e.py's pairs: a random image and its copy
    shifted by one pixel, at 32x48 with the raw frames."""

    def __len__(self):
        return 8

    def __getitem__(self, i):
        rng = np.random.RandomState(i)
        raw = rng.rand(48, 64, 3).astype(np.float32)
        raw2 = np.roll(raw, 1, axis=1)
        return {"im1_raw": raw, "im2_raw": raw2, "im1": raw[8:40, 8:56],
                "im2": raw2[8:40, 8:56],
                "start": np.array([8, 8], np.float32)}


def run_trainer(job, mesh):
    """Run A trains to step 2 (an epoch: evaluation and checkpoint), run B
    resumes it in a fresh Trainer and trains to step 4."""
    from upflow_pytorch_tpu_torch.checkpoint.state_io import latest_step
    from upflow_pytorch_tpu_torch.eval.bench import (
        EvalSample, EvaluationBench)
    from upflow_pytorch_tpu_torch.train import trainer as trainer_mod

    rng = np.random.RandomState(3)
    flow = rng.randn(1, 32, 48, 2).astype(np.float32)
    mask = np.ones((1, 32, 48, 1), np.float32)
    bench = EvaluationBench([EvalSample(
        im1=rng.rand(1, 32, 48, 3).astype(np.float32),
        im2=rng.rand(1, 32, 48, 3).astype(np.float32), flow_occ=flow,
        mask_occ=mask, flow_noc=flow.copy(), mask_noc=mask, name="s0")])
    saved, logs = [], []
    real_save = trainer_mod.save_checkpoint

    def save(directory, step, payload):
        saved.append(step)
        real_save(directory, step, payload)

    conf = UPFlowConfig().updated(job["knobs"])
    tconf = TrainerConfig(exp_dir=job["exp_dir"], batchsize=2,
                          batch_per_epoch=2, batch_per_print=1, num_workers=2,
                          eq_loss_weight=0.1,
                          data_axis=1 if mesh is None else mesh.size)
    trainer_mod.save_checkpoint = save
    losses = []

    def recording(trainer):
        step = trainer.train_step

        def recorded(state, batch):
            state, metrics = step(state, batch)
            losses.append(float(metrics["total_loss"]))
            return state, metrics

        trainer.train_step = recorded

    with threshold(job["threshold"]):
        a = trainer_mod.Trainer(conf, tconf, Pairs(), bench,
                                log_fn=logs.append, device="cpu")
        recording(a)
        a.train(total_steps=2)
        a.loader.close()
        b = trainer_mod.Trainer(conf, tconf, Pairs(), None,
                                log_fn=logs.append, device="cpu")
        resumed = b.try_resume()
        cursor = b.loader.state()
        resumed_step = b.state.step
        recording(b)
        b.train(total_steps=4)
        b.loader.close()
    trainer_mod.save_checkpoint = real_save
    return {"saved": np.array(saved), "logs": np.array(logs),
            "resumed": np.array(resumed),
            "cursor": np.array([cursor["epoch"], cursor["position"]]),
            "resumed_step": np.array(resumed_step),
            "step": np.array(b.state.step), "device": np.array(str(b.device)),
            "latest": np.array(latest_step(b.ckpt_dir)),
            "losses": np.array(losses),
            "params": flat(p for _, p in sorted(b.model.named_parameters()))}


RUNNERS = {"step": run_step, "eval": run_eval, "loader": run_loader,
           "trainer": run_trainer}
'''

_WORKER = _JOBS + r'''
import datetime
import json
import sys

torch.set_num_threads(1)
rank, world, init_method, spec = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], sys.argv[4])
pmesh.init_distributed(rank=rank, world_size=world, init_method=init_method,
                       device="cpu", timeout=datetime.timedelta(
                           seconds=float(sys.argv[5])))
try:
    mesh = pmesh.make_mesh(data=world, device="cpu")
    with open(spec) as f:
        jobs = json.load(f)
    for name, job in jobs.items():
        np.savez(job["out"] % rank, **RUNNERS[job["kind"]](job, mesh))
    print("WORKER_DONE", rank, flush=True)
finally:
    pmesh.close_distributed()
'''

# the Trainer at data_axis=2: run A trains to step 2 (an epoch: evaluation
# and checkpoint), run B resumes it and trains to step 4
# scripts/torch_train_kitti.py started as torchrun starts it (RANK,
# WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT in the environment)
_CLI_WORKER = r'''
import functools
import hashlib
import sys

import torch

torch.set_num_threads(1)
sys.path.insert(0, sys.argv[1] + "/scripts")
import torch_train_kitti
from upflow_pytorch_tpu_torch.data import kitti

torch_train_kitti.KittiMultiviewDataset = functools.partial(
    kitti.KittiMultiviewDataset, crop_size=(32, 64), rho=4)
trainer = torch_train_kitti.main(sys.argv[2:])
params = torch.cat([p.detach().reshape(-1)
                    for _, p in sorted(trainer.model.named_parameters())])
print("CLI_DONE step=%d mesh=%d params=%s" % (
    trainer.state.step, trainer.mesh.size,
    hashlib.sha256(params.numpy().tobytes()).hexdigest()), flush=True)
'''


def _start(tmp, script, argvs, envs=None):
    """Starts ``script`` once per argument list, each process on one
    thread."""
    path = tmp / ("worker_%d.py" % len(list(tmp.glob("worker_*.py"))))
    path.write_text(script)
    base = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
        OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, str(path)] + [str(a) for a in argv], cwd=str(ROOT),
        env=dict(base, **(envs[i] if envs else {})), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for i, argv in enumerate(argvs)]


def _wait(procs):
    """Waits for every process (``TIMEOUT`` each) and returns their
    outputs; a process that fails fails the test with its output."""
    try:
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, "rank %d failed:\n%s" % (i, out[-6000:])
    return outs


def _spawn(tmp, script, argvs, envs=None):
    return _wait(_start(tmp, script, argvs, envs))


def _run_jobs(tmp, jobs):
    """Starts the 2 ranks on ``jobs``; returns their processes."""
    for job in jobs.values():
        job.setdefault("out", str(tmp / (job["name"] + "_rank%d.npz")))
    spec = tmp / ("jobs_%d.json" % len(list(tmp.glob("jobs_*.json"))))
    spec.write_text(json.dumps(jobs))
    init = _store(tmp)
    return _start(tmp, _WORKER, [[r, 2, init, spec, TIMEOUT]
                                 for r in range(2)])


def _results(jobs):
    got = {}
    for name, job in jobs.items():
        got[name] = []
        for r in range(2):
            with np.load(job["out"] % r) as z:
                got[name].append({k: z[k] for k in z.files})
    return got


def _store(tmp):
    return "file://" + str(tmp / ("store_%d" % len(list(tmp.glob("*")))))


def _batch(contrast=False):
    """Two synthetic pairs at 32x48; with ``contrast`` the second pair's
    second frame is a third pair's, so the two halves have very different
    visible-pixel sums."""
    d = make_dataset(3, seed=3, raw_hw=(48, 64), crop_hw=(32, 48))
    b = {k: v[:2].copy() for k, v in d.items() if k != "gt_flow"}
    if contrast:
        b["im2"][1], b["im2_raw"][1] = d["im2"][2], d["im2_raw"][2]
    return b


def _parallel_batch(b=2, h=32, w=48, margin=8):
    """``tests/test_parallel.py::make_batch``: random frames, the second
    rolled by two pixels."""
    rng = np.random.RandomState(0)
    raw = rng.rand(b, h + 2 * margin, w + 2 * margin, 3).astype(np.float32)
    raw2 = np.roll(raw, 2, axis=2)
    return {"im1_raw": raw, "im2_raw": raw2,
            "im1": raw[:, margin:margin + h, margin:margin + w],
            "im2": raw2[:, margin:margin + h, margin:margin + w],
            "start": np.full((b, 2), float(margin), np.float32)}


def _jobs(tmp):
    for name, batch in (("batch", _batch()), ("contrast", _batch(True)),
                        ("parallel", _parallel_batch())):
        np.savez(tmp / (name + ".npz"), **batch)
    batch, contrast = str(tmp / "batch.npz"), str(tmp / "contrast.npz")
    step = dict(kind="step", knobs=KNOBS, weights=NPZ, eq_weight=0.0,
                batch=batch, threshold=RELAXED_THRESHOLD)
    jobs = {
        "step": dict(step, knobs=PARALLEL_KNOBS, weights=None,
                     batch=str(tmp / "parallel.npz"), threshold=1.0),
        "step_robust": step,
        "eq": dict(step, eq_weight=0.1),
        "contrast": dict(step, batch=contrast),
        "contrast_per_rank": dict(step, batch=contrast, per_rank=True),
        "eval": dict(kind="eval", knobs=KNOBS, weights=NPZ, batch=batch,
                     threshold=RELAXED_THRESHOLD),
        "loader": dict(kind="loader"),
        "trainer": dict(kind="trainer", knobs=TRAINER_KNOBS,
                        exp_dir=str(tmp / "exp"),
                        threshold=RELAXED_THRESHOLD),
    }
    for name, job in jobs.items():
        job["name"] = name
    return jobs


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This process's steps on one thread, as the ranks run: many small
    ops, which on a loaded machine stall on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jobs_ns():
    ns = {}
    exec(compile(_JOBS, "_JOBS", "exec"), ns)
    return ns


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jobs_ns):
    """Every job on 2 ranks (one output per rank) and, while they run, in
    this process (``single``; the trainer in its own directory)."""
    tmp = tmp_path_factory.mktemp("parallel")
    jobs = _jobs(tmp)
    procs = _run_jobs(tmp, jobs)
    single = {}
    for name, job in jobs.items():
        if name == "trainer":
            job = dict(job, exp_dir=str(tmp / "exp_single"))
        single[name] = jobs_ns["RUNNERS"][job["kind"]](job, None)
    outs = _wait(procs)
    assert all("WORKER_DONE" in out for out in outs)
    return dict(ranks=_results(jobs), single=single)


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _terms(out):
    return [k for k in ("total_loss", "photo_loss", "smooth_loss",
                        "census_loss", "msd_loss", "eq_loss") if k in out]


def test_two_ranks_match_one_process_at_the_reference_threshold(ranks):
    """``tests/test_parallel.py``'s recipe and batch from seeded weights,
    at the reference's mask threshold 1.0: 2 ranks at B/2 report the
    global loss within the JAX bar of one process at B, and equal bits
    on both ranks (loss, terms, parameters, gradients).  The terms and
    gradients are not held here: a B=1 forward and a B=2 forward round
    their convolutions differently, and the chaotic mask turns that into
    flows up to 0.8 px apart in one process as well."""
    r0, r1 = ranks["ranks"]["step"]
    one = ranks["single"]["step"]
    for key in ["params", "grads"] + _terms(one):
        assert np.array_equal(r0[key], r1[key]), key
    assert _rel(r0["total_loss"], one["total_loss"]) <= LOSS_BAR


@pytest.mark.parametrize("name", ["step_robust", "eq"])
def test_two_ranks_match_one_process(ranks, name):
    """The masked recipe from the trained snapshot at threshold 0.9999,
    without and with the equivariance pass: 2 ranks at B/2 against one
    process at B, every term within the robust bar, the ranks equal bit
    for bit, the gradient and the update along the single process's."""
    r0, r1 = ranks["ranks"][name]
    one = ranks["single"][name]
    terms = _terms(one)
    assert ("eq_loss" in terms) == (name == "eq")
    for key in ["params", "grads"] + terms:
        assert np.array_equal(r0[key], r1[key]), key
    for key in terms:
        assert _rel(r0[key], one[key]) <= ROBUST_LOSS_BAR, key
    assert _cos(r0["grads"], one["grads"]) >= GRAD_COSINE_BAR
    assert _cos(r0["update"], one["update"]) >= UPDATE_COSINE_BAR
    assert np.abs(r0["update"]).max() > 0


def test_per_rank_normalisers_miss_the_bar(ranks):
    """The sensitivity check: on a batch whose halves have very different
    visible-pixel sums, the global normalisers hold the loss to the
    single process's, and per-rank normalisers miss by more than 10x the
    loss bar."""
    one = ranks["single"]["contrast"]["total_loss"]
    right = ranks["ranks"]["contrast"][0]["total_loss"]
    wrong = ranks["ranks"]["contrast_per_rank"][0]["total_loss"]
    assert _rel(right, one) <= ROBUST_LOSS_BAR
    assert _rel(wrong, one) >= 10 * LOSS_BAR, (wrong, one)


@pytest.mark.slow
def test_two_ranks_match_the_jax_sharded_step(tmp_path, monkeypatch):
    """The port's 2-rank step against ``upflow_pytorch_tpu``'s
    ``make_sharded_train_step`` on a 2-device mesh, from the same weights
    and batch, at threshold 0.9999 on both sides."""
    monkeypatch.setattr(jwarp, "MASK_THRESHOLD", RELAXED_THRESHOLD)
    model, state, tx = jstep.create_train_state(
        JaxConfig().updated(JAX_KNOBS), JaxTrainerConfig())
    with np.load(NPZ) as z:
        params = flax.traverse_util.unflatten_dict(
            {tuple(k.split("/")): z[k] for k in z.files})
    state = state._replace(params=params, opt_state=tx.init(params))
    mesh = jmesh.make_mesh(data=2)
    step = jpstep.make_sharded_train_step(model, tx, mesh)
    jobs = {"jax": dict(kind="step", name="jax", knobs=JAX_KNOBS,
                        weights=NPZ, eq_weight=0.0,
                        batch=str(tmp_path / "batch.npz"),
                        threshold=RELAXED_THRESHOLD)}
    np.savez(tmp_path / "batch.npz", **_batch())
    procs = _run_jobs(tmp_path, jobs)
    _, metrics = step(jmesh.replicate(mesh, state),
                      jmesh.shard_batch(mesh, _batch()))
    _wait(procs)
    port = _results(jobs)["jax"][0]["total_loss"]
    assert _rel(port, metrics["total_loss"]) <= LOSS_BAR


def test_eval_step_gathers_the_global_batch(ranks):
    """Every rank holds the whole batch's four outputs, its own rows
    exactly its local forward's, equal to one process's forward at B."""
    r0, r1 = ranks["ranks"]["eval"]
    one = ranks["single"]["eval"]
    assert r0["own_rows_exact"] and r1["own_rows_exact"]
    for key in ("flow_f_out", "flow_b_out", "occ_fw", "occ_bw"):
        assert np.array_equal(r0[key], r1[key]), key
        assert r0[key].shape == one[key].shape
    assert np.abs(r0["flow_f_out"] - one["flow_f_out"]).max() < 1e-4
    assert np.array_equal(r0["occ_fw"], one["occ_fw"])
    assert np.array_equal(r0["occ_bw"], one["occ_bw"])


def test_sharded_loader_concatenates_to_the_unsharded(ranks):
    """Each rank's slices, concatenated, are the unsharded loader's
    batches bit for bit, across two epoch ends and after ``set_cursor``;
    the cursor counts global batches on every rank."""
    r0, r1 = ranks["ranks"]["loader"]
    one = ranks["single"]["loader"]
    batches = [k for k in one if k != "state"]
    assert len(batches) == 16
    for key in batches:
        assert r0[key].shape[0] == 2
        assert np.array_equal(np.concatenate([r0[key], r1[key]]), one[key])
    assert r0["state"].tolist() == r1["state"].tolist() == \
        one["state"].tolist() == [2, 1]


def test_trainer_trains_checkpoints_once_and_resumes_on_both_ranks(ranks):
    """``Trainer`` at data_axis=2: rank 0 alone logs, evaluates and writes
    the checkpoints (steps 2 and 4); both ranks resume step 2 with the
    loader's cursor and end with the same parameters and losses.  Against
    one process (``data_axis=1``) at threshold 0.9999 the first step is
    held to the robust bar and the second to the loss bar; later steps
    are not held: Adam's first steps move each parameter by about the
    learning rate times its gradient's sign, so a near-zero gradient
    component that rounds to the other sign moves a whole step apart,
    and the losses drift about 100x a step (measured 1.3e-7, 2.4e-6,
    3.1e-4, 6.2e-3 relative over steps 1-4)."""
    r0, r1 = ranks["ranks"]["trainer"]
    one = ranks["single"]["trainer"]
    assert r0["saved"].tolist() == [2, 4] and r1["saved"].tolist() == []
    assert int(r0["latest"]) == int(r1["latest"]) == 4
    logs = r0["logs"].tolist()
    assert any(line.startswith("eval @2: EPE All=") for line in logs)
    assert "resumed from step 2" in logs
    assert r1["logs"].size == 0
    for r in (r0, r1):
        assert bool(r["resumed"]) and int(r["resumed_step"]) == 2
        assert int(r["step"]) == 4 and r["cursor"].tolist() == [0, 2]
        assert str(r["device"]) == "cpu" and len(r["losses"]) == 4
        assert np.isfinite(r["losses"]).all()
    assert np.array_equal(r0["params"], r1["params"])
    assert np.array_equal(r0["losses"], r1["losses"])
    rel = [_rel(a, b) for a, b in zip(r0["losses"], one["losses"])]
    assert rel[0] <= ROBUST_LOSS_BAR and rel[1] <= LOSS_BAR, rel


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_train_kitti_cli_on_two_ranks(tmp_path):
    """``torch_train_kitti.py --data-axis 2 --device cpu`` in two
    processes started as torchrun starts them: two steps from a ``.pth``,
    rank 0's evaluation and checkpoint, the same parameters on both
    ranks."""
    root = tmp_path / "trees"
    with pytest.MonkeyPatch.context() as mp:
        for name, value in SMALL_TREES.items():
            mp.setattr(trees, name, value)
        trees.write_trees(str(root), seed=5, workers=2)
    model = entry.build_model(torch_kitti_eval.EVAL_CONF, device="cpu",
                              weights=NPZ)
    pth = tmp_path / "snapshot.pth"
    torch.save(torch_import.params_to_torch_state_dict(model), pth)
    port = str(_free_port())
    envs = [dict(RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
            for r in range(2)]
    argv = [ROOT, "--mv-root", root, "--eval-root", root, "--exp-dir",
            tmp_path / "exp", "--batch", "2", "--batch-per-epoch", "2",
            "--steps", "2", "--data-axis", "2", "--device", "cpu",
            "--pretrained", pth]
    outs = _spawn(tmp_path, _CLI_WORKER, [argv, argv], envs)
    done = [line for out in outs for line in out.splitlines()
            if line.startswith("CLI_DONE")]
    assert len(done) == 2 and done[0] == done[1]
    assert "step=2 mesh=2" in done[0]
    assert "eval @2: EPE All=" in outs[0] and "eval @" not in outs[1]
    assert "loaded 80 keys" in outs[0] and "loaded" not in outs[1]
    assert state_io.latest_step(str(tmp_path / "exp" / "ckpts")) == 2


def test_dryrun_multigpu_on_two_cpu_ranks(capsys, monkeypatch):
    """``dryrun_multigpu(2, "cpu")``: one step of ``TRAIN_CONF`` over two
    gloo processes, its loss within the robust bar of one process's, both
    under ``UPFLOW_ROBUST_MASK`` (the ranks inherit it, and one thread)."""
    monkeypatch.setenv("UPFLOW_ROBUST_MASK", "1")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    loss = dryrun.dryrun_multigpu(2, "cpu", timeout=TIMEOUT)
    assert "dryrun_multigpu(2): total_loss=" in capsys.readouterr().out
    model, state, opt = pstep.create_train_state(
        dryrun.TRAIN_CONF, TrainerConfig(), device="cpu")
    _, metrics = pstep.make_train_step(model, opt)(
        state, dryrun.dryrun_batch(2))
    assert _rel(loss, metrics["total_loss"]) <= ROBUST_LOSS_BAR


def test_one_rank_group_equals_the_plain_step(tmp_path):
    """A group of one (gloo, in this process): the sharded step's loss and
    parameters equal ``make_train_step``'s bit for bit, as the card's
    one-rank NCCL group must."""
    batch = _batch()
    conf = UPFlowConfig().updated(KNOBS)
    runs = []
    pmesh.init_distributed(rank=0, world_size=1, init_method=_store(tmp_path),
                           device="cpu",
                           timeout=datetime.timedelta(seconds=TIMEOUT))
    try:
        for mesh in (None, pmesh.make_mesh(device="cpu")):
            model, state, opt = pstep.create_train_state(
                conf, TrainerConfig(), device="cpu", weights=NPZ)
            if mesh is None:
                step = pstep.make_train_step(model, opt, eq_loss_weight=0.1)
            else:
                step = make_sharded_train_step(model, opt, mesh,
                                               eq_loss_weight=0.1)
            _, metrics = step(state, batch)
            runs.append((float(metrics["total_loss"]),
                         [p.detach().clone() for p in model.parameters()]))
    finally:
        pmesh.close_distributed()
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_normalisers_are_the_identity_outside_a_group():
    """No group, or a mesh of one: the helpers return their argument."""
    x = torch.tensor(3.5)
    helpers = (reduce.global_sum, reduce.global_mean, reduce.rank_share)
    assert all(fn(x) is x for fn in helpers)
    with reduce.global_normalisers(
            pmesh.Mesh(None, 1, 0, torch.device("cpu"))):
        assert all(fn(x) is x for fn in helpers)


def test_make_mesh_takes_the_card_unless_asked_for_the_cpu(tmp_path,
                                                          monkeypatch):
    """A group started by ``init_process_group`` itself, over gloo: the
    mesh is on the current CUDA device whatever the backend, on the CPU
    only when the caller asks for it, and refused without CUDA; a NCCL
    group refuses a CPU mesh."""
    dist.init_process_group(
        "gloo", init_method=_store(tmp_path), rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=TIMEOUT))
    try:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pmesh.make_mesh()
        assert pmesh.make_mesh(device="cpu").device == torch.device("cpu")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
        for device in (None, "cuda"):
            mesh = pmesh.make_mesh(data=1, device=device)
            assert mesh.device == torch.device("cuda", 3)
            assert (mesh.size, mesh.rank) == (1, 0)
        monkeypatch.setattr(dist, "get_backend", lambda *a: "nccl")
        with pytest.raises(ValueError, match="NCCL"):
            pmesh.make_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def test_refusals(tmp_path, monkeypatch):
    """``data_axis > 1`` without a group, a frame too narrow for its width
    shards, a batch that does not split, NCCL for CPU tensors, and no
    silent gloo or CPU on a card."""
    with pytest.raises(RuntimeError, match="needs a process group"):
        Trainer(UPFlowConfig(), TrainerConfig(
            exp_dir=str(tmp_path), batchsize=2, data_axis=2), [],
            device="cpu")
    with pytest.raises(ValueError, match="split evenly"):
        TrainerConfig(batchsize=3, data_axis=2)
    model = entry.build_model(UPFlowConfig().updated(KNOBS), device="cpu")
    frame = np.zeros((1, 64, 128, 3), np.float32)
    with pytest.raises(ValueError, match="pyramid level 1/64 is 2 columns "
                       "wide: split over 3 ranks it leaves a rank no column"):
        entry.forward(model, frame, frame, WidthShard(None, 0, 3))
    mesh = pmesh.Mesh(None, 2, 1, torch.device("cpu"))
    assert mesh.rows(4) == slice(2, 4)
    with pytest.raises(ValueError, match="does not split"):
        pmesh.shard_batch(mesh, {"im1": np.zeros((3, 4, 4, 3))})
    with pytest.raises(ValueError):
        DataLoader([], batch_size=3, shard=(0, 2))
    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    with pytest.raises(ValueError, match="NCCL reduces CUDA tensors"):
        pmesh.resolve_backend(cpu, "nccl")
    with pytest.raises(ValueError, match="NCCL reduces CUDA tensors"):
        pmesh.init_distributed(rank=0, world_size=1, device="cpu",
                               backend="nccl", init_method=_store(tmp_path))
    assert not dist.is_initialized()
    assert pmesh.resolve_backend(cpu, None) == "gloo"
    assert pmesh.resolve_backend(card, "gloo") == "gloo"
    monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="no NCCL"):
        pmesh.resolve_backend(card, None)
    monkeypatch.setattr(dist, "is_nccl_available", lambda: True)
    assert pmesh.resolve_backend(card, None) == "nccl"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.init_distributed(rank=0, world_size=1,
                               init_method=_store(tmp_path))
    for key in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        pmesh.init_distributed(device="cpu")
    assert not dist.is_initialized()
