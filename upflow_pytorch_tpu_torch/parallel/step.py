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

The JAX steps turn the Pallas kernels off on a mesh of more than one
device (``ops/pallas_gate.py``).  Each rank here runs whole frames, so
every kernel stays on and nothing is gated.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from upflow_pytorch_tpu_torch.models.upflow import UPFlowNet, forward
from upflow_pytorch_tpu_torch.parallel.mesh import (
    SPATIAL_REFUSAL, Mesh, shard_batch)
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
    each rank runs ``models/upflow.py::forward`` on its slice of the global
    NHWC batch, and every rank gets the outputs of the whole batch on its
    device.  The outputs are gathered by an all-reduce of each rank's
    slice written into a zeroed global buffer (exact; one path for NCCL
    and for gloo, whose all-gather takes no CUDA tensors)."""
    if spatial:
        raise NotImplementedError(SPATIAL_REFUSAL % mesh.size)

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
