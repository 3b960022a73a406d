"""The sharded train and eval steps.

Port of ``upflow_pytorch_tpu/parallel/step.py``.  The JAX package jits one
GSPMD program over the mesh, with the parameters replicated and the batch
sharded over 'data'.  Here each rank runs the step on its slice of the
global batch, and the reductions that make the ranks compute the global
batch's step are explicit (``train/step.py`` with a mesh,
``parallel/reduce.py``): the loss's normalisers, one flat all-reduce of the
gradients, the metrics.  No ``DistributedDataParallel``: the equivariance
step runs two forwards (teacher, student) before its one backward, which
DDP's reducer does not expect.

The eval step with ``spatial=True`` also shards the frame's width over
the mesh's 'spatial' axis: each rank computes its columns of every map
(``parallel/spatial.py``, ``models/entry.py::forward`` with a shard).

The JAX steps turn the Pallas kernels off on a mesh of more than one
device (``ops/pallas_gate.py``).  Here every kernel stays on, whole frames
or width shards, and nothing is gated.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from upflow_pytorch_tpu_torch.models.entry import forward
from upflow_pytorch_tpu_torch.models.upflow import UPFlowNet
from upflow_pytorch_tpu_torch.parallel.mesh import Mesh, shard_batch
from upflow_pytorch_tpu_torch.parallel.spatial import WidthShard
from upflow_pytorch_tpu_torch.train.step import make_train_step

EVAL_OUTPUTS = ("flow_f_out", "flow_b_out", "occ_fw", "occ_bw")


def make_sharded_train_step(model: UPFlowNet,
                            optimizer: torch.optim.Optimizer, mesh: Mesh,
                            **step_kwargs):
    """``train_step(state, batch) -> (state, metrics)`` on this rank's
    slice of the global batch (``shard_batch``, or a loader built with
    ``shard``); the parameters and the optimizer's state must start equal
    on every rank (``replicate``) and stay so.  ``step_kwargs`` are
    ``make_train_step``'s."""
    return make_train_step(model, optimizer, mesh=mesh, **step_kwargs)


def make_sharded_eval_step(model: UPFlowNet, mesh: Mesh,
                           spatial: bool = False):
    """``eval_step(im1, im2) -> (flow_f_out, flow_b_out, occ_fw, occ_bw)``:
    each rank runs ``models/entry.py::forward`` on its slice of the global
    NHWC batch, and every rank gets the outputs of the whole batch on its
    device.  The outputs are gathered by an all-reduce of each rank's
    slice written into a zeroed global buffer (exact; one path for NCCL
    and for gloo, whose all-gather takes no CUDA tensors).

    With ``spatial`` on a mesh whose 'spatial' axis has more than one rank
    each rank also takes its columns of the frames: it runs the forward on
    its data rows with the mesh's ``WidthShard``, and the world gathers
    every rank's block of rows and columns, over an integer view of the
    buffer so that each value arrives bit for bit.  The shard, whose
    counters say what a rank moved, is ``eval_step.shard``.  On a mesh
    with one 'spatial' rank ``spatial=True`` is the step without it."""
    if spatial and mesh.spatial > 1:
        return _width_sharded_eval_step(model, mesh)

    def eval_step(im1, im2):
        local = forward(model, shard_batch(mesh, im1),
                        shard_batch(mesh, im2))
        rows = mesh.rows(len(im1))
        outs = []
        for key in EVAL_OUTPUTS:
            part = local[key]
            full = part.new_zeros((len(im1),) + tuple(part.shape[1:]))
            full[rows] = part
            dist.all_reduce(full, group=mesh.group)
            outs.append(full)
        return tuple(outs)

    return eval_step


def _width_sharded_eval_step(model: UPFlowNet, mesh: Mesh):
    shard = WidthShard(mesh.spatial_group, mesh.spatial_rank, mesh.spatial)

    def eval_step(im1, im2):
        rows = mesh.rows(len(im1))
        local = forward(model, im1[rows], im2[rows], shard)
        lo, hi = shard.cols(im1.shape[2])
        outs = []
        for key in EVAL_OUTPUTS:
            part = local[key]
            full = part.new_zeros((len(im1), part.shape[1], im1.shape[2])
                                  + tuple(part.shape[3:]))
            full[rows, :, lo:hi] = part
            dist.all_reduce(full.view(torch.int32))
            outs.append(full)
        return tuple(outs)

    eval_step.shard = shard
    return eval_step
