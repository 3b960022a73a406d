"""One full training step over an n-rank group, on tiny shapes.

Port of ``__graft_entry__.py::dryrun_multichip``: the training recipe
``TRAIN_CONF`` (the eval recipe with SGU, plus census, the 'upup'
distillation and the boundary-dilated warp; AMSGrad) from seeded weights,
replicated over the 'data' mesh, one sharded step on a global batch of n
items (64x64 crops of 80x80 frames, one a rank), and the global loss
printed.  Then, at an even n, the JAX dry run's width-sharded rehearsal:
the eval recipe with SGU from seeded weights on a ('data', 'spatial') =
(n/2, 2) mesh, one 64x128 frame a data row, its width split over the two
'spatial' ranks (``make_sharded_eval_step(spatial=True)``), and the
flow's shape printed.  Called outside an n-rank group,
``dryrun_multigpu`` starts n processes joined through a ``file://``
store and waits for them; inside one, it runs both in this process.

    python -m upflow_pytorch_tpu_torch.parallel.dryrun 2 --device cpu
"""

from __future__ import annotations

import argparse
import datetime
import os
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from upflow_pytorch_tpu_torch.config import TrainerConfig, UPFlowConfig
from upflow_pytorch_tpu_torch.parallel.mesh import (
    Mesh, close_distributed, init_distributed, make_mesh, replicate,
    shard_batch)
from upflow_pytorch_tpu_torch.models.entry import build_model
from upflow_pytorch_tpu_torch.parallel.step import (
    make_sharded_eval_step, make_sharded_train_step)
from upflow_pytorch_tpu_torch.train.step import create_train_state

ROOT = Path(__file__).resolve().parents[2]
EVAL_CONF = UPFlowConfig().updated(dict(
    if_norm_before_cost_volume=True,
    norm_moments_across_channels=False,
    norm_moments_across_images=False,
    if_sgu_upsample=True,
    if_use_cor_pytorch=True,
))
TRAIN_CONF = EVAL_CONF.updated(dict(
    photo_loss_census_weight=1.0,
    multi_scale_distillation_weight=0.01,
    multi_scale_distillation_style="upup",
    multi_scale_distillation_occ=True,
    if_use_boundary_warp=True,
))
LINE = "dryrun_multigpu(%d): total_loss=%.6f over %d ranks (%s, %s)"
SPATIAL = 2  # the rehearsal's 'spatial' ranks
SPATIAL_LINE = "dryrun_multigpu: spatial=%d full-model eval ok %s"


def dryrun_batch(b: int, h: int = 64, w: int = 64, margin: int = 8):
    """``__graft_entry__.py``'s dry-run batch: random frames, the second
    rolled by one pixel, crops at ``margin``."""
    rng = np.random.RandomState(0)
    raw = rng.rand(b, h + 2 * margin, w + 2 * margin, 3).astype(np.float32)
    raw2 = np.roll(raw, 1, axis=2)
    return {
        "im1_raw": raw,
        "im2_raw": raw2,
        "im1": raw[:, margin:margin + h, margin:margin + w],
        "im2": raw2[:, margin:margin + h, margin:margin + w],
        "start": np.full((b, 2), float(margin), np.float32),
    }


def dryrun_step(mesh: Mesh) -> float:
    """One sharded step of ``TRAIN_CONF`` on this rank; returns the global
    total loss."""
    model, state, optimizer = create_train_state(
        TRAIN_CONF, TrainerConfig(), device=mesh.device)
    replicate(mesh, model, optimizer)
    step = make_sharded_train_step(model, optimizer, mesh)
    _, metrics = step(state, shard_batch(mesh, dryrun_batch(mesh.size)))
    loss = float(metrics["total_loss"])
    print(LINE % (mesh.size, loss, mesh.size, dist.get_backend(mesh.group),
                  mesh.device), flush=True)
    return loss


def dryrun_spatial(n: int, device) -> None:
    """The width-sharded rehearsal over the group's ``n`` ranks (even):
    the SGU eval recipe from seeded weights on a (n/2, 2) mesh, one
    64x128 frame a data row; prints the gathered flow's shape."""
    mesh = make_mesh(data=n // SPATIAL, spatial=SPATIAL, device=device)
    model = build_model(EVAL_CONF, mesh.device, seed=0)
    im = np.random.RandomState(1).rand(mesh.size, 64, 128, 3).astype(
        np.float32)
    flow_f = make_sharded_eval_step(model, mesh, spatial=True)(im, im)[0]
    print(SPATIAL_LINE % (SPATIAL, tuple(flow_f.shape)), flush=True)


def dryrun_ranks(n: int, device) -> float:
    """One rank's part of the dry run: the step, then, at an even n, the
    width-sharded rehearsal.  Returns the global loss."""
    mesh = make_mesh(data=n, device=device)
    loss = dryrun_step(mesh)
    if n % SPATIAL == 0:
        dryrun_spatial(n, mesh.device)
    return loss


def dryrun_multigpu(n: int, device=None, timeout: float = 600.0) -> float:
    """The dry run over ``n`` ranks: on ``n`` cards over NCCL, or with
    ``device="cpu"`` in ``n`` CPU processes over gloo.  Returns the global
    loss, which every rank must report alike; ``timeout`` (seconds) bounds
    the group's collectives and the wait for the processes."""
    if dist.is_initialized():
        return dryrun_ranks(n, device)
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if not on_cpu and torch.cuda.device_count() < n:
        raise RuntimeError(
            "dryrun_multigpu(%d) needs %d cards, %d visible; device='cpu' "
            "runs it over gloo" % (n, n, torch.cuda.device_count()))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    with tempfile.TemporaryDirectory() as tmp:
        store = "file://" + os.path.join(tmp, "store")
        cmd = [sys.executable, "-m",
               "upflow_pytorch_tpu_torch.parallel.dryrun", str(n),
               "--timeout", str(timeout), "--init-method", store]
        if on_cpu:
            cmd += ["--device", "cpu"]
        procs = [subprocess.Popen(cmd + ["--rank", str(rank)], cwd=str(ROOT),
                                  env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for rank in range(n)]
        try:
            outs = [p.communicate(timeout=timeout)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError("dryrun_multigpu rank %d exited with %d:\n%s"
                               % (rank, p.returncode, out[-4000:]))
    lines = [line for out in outs for line in out.splitlines()
             if line.startswith("dryrun_multigpu(")]
    losses = {line.split("total_loss=")[1].split()[0] for line in lines}
    if len(lines) != n or len(losses) != 1:
        raise RuntimeError("the ranks disagree: %s" % lines)
    print(lines[0], flush=True)
    spatial = [line for out in outs for line in out.splitlines()
               if line.startswith("dryrun_multigpu: spatial=")]
    if n % SPATIAL == 0:
        if len(spatial) != n or len(set(spatial)) != 1:
            raise RuntimeError("the spatial rehearsal's ranks disagree: %s"
                               % spatial)
        print(spatial[0], flush=True)
    return float(losses.pop())


def main(argv: Optional[Sequence[str]] = None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("n", type=int, help="ranks")
    ap.add_argument("--device", default=None,
                    help="'cpu' for gloo on the CPU (default: a card a rank)")
    ap.add_argument("--rank", type=int, default=None,
                    help="this process's rank (default: start all n)")
    ap.add_argument("--init-method", default=None)
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    if args.rank is None:
        return dryrun_multigpu(args.n, args.device, args.timeout)
    if args.device == "cpu" and "OMP_NUM_THREADS" not in os.environ:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.n))
    device = init_distributed(
        rank=args.rank, world_size=args.n, local_rank=args.rank,
        init_method=args.init_method, device=args.device,
        timeout=datetime.timedelta(seconds=args.timeout))
    try:
        return dryrun_ranks(args.n, device)
    finally:
        close_distributed()


if __name__ == "__main__":
    main()
