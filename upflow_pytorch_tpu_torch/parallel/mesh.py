"""The process group, the data-parallel mesh and the sharding helpers.

Port of ``upflow_pytorch_tpu/parallel/mesh.py``.  The JAX package builds a
``jax.sharding.Mesh`` over the devices of its processes and lets GSPMD
shard one program over it.  The port runs one process a card
(``torchrun --nproc_per_node N``), joined by a ``torch.distributed``
group: parameters and optimizer state are replicated, each rank takes a
contiguous slice of the global batch, and ``parallel/reduce.py`` sums
what the loss and the gradients need over the ranks.

``init_distributed`` is the counterpart of ``jax.distributed.initialize``:
NCCL on ``cuda:LOCAL_RANK`` by default, gloo only where the caller asks
for it (``device="cpu"``, or ``backend="gloo"``).  ``make_mesh(data=D,
spatial=S)`` lays the D*S ranks out as the JAX ('data', 'spatial') mesh,
rank ``r = d*S + s``: the batch splits over 'data' (``Mesh.group``, the D
ranks of one spatial column, over which the train step reduces), and the
eval step's width over 'spatial' (``Mesh.spatial_group``, the S ranks of
one data row; ``parallel/spatial.py``).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

from upflow_pytorch_tpu_torch.utils.misc import host_tensor, resolve_device

DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)

def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value is None else int(value)


def resolve_backend(device: torch.device, backend: Optional[str]) -> str:
    """The backend for a group on ``device``: NCCL on a CUDA device unless
    gloo is asked for, gloo on the CPU.  Raises where the choice cannot
    work (NCCL for CPU tensors, or a torch built without NCCL) instead of
    taking another backend."""
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError("backend must be 'nccl' or 'gloo', got %r"
                         % (backend,))
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(
                "NCCL reduces CUDA tensors only; device %s needs "
                "backend='gloo'" % device)
        if not dist.is_nccl_available():
            raise RuntimeError(
                "this torch has no NCCL; pass backend='gloo' to reduce over "
                "gloo instead")
    return backend


def init_distributed(rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     local_rank: Optional[int] = None,
                     init_method: Optional[str] = None,
                     backend: Optional[str] = None, device=None,
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT
                     ) -> torch.device:
    """Joins this process to the group and returns its device.

    ``rank``, ``world_size`` and ``local_rank`` default to torchrun's
    ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``; ``init_method`` to
    ``env://`` (``MASTER_ADDR``, ``MASTER_PORT``).  ``device`` defaults to
    ``cuda:LOCAL_RANK`` (raising without CUDA); ``"cpu"`` runs the group
    over gloo.  ``backend`` defaults to NCCL on a CUDA device
    (``resolve_backend``).  ``timeout`` bounds every collective, so a rank
    that never arrives fails the others instead of hanging them."""
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialised")
    rank = _env_int("RANK") if rank is None else rank
    world_size = _env_int("WORLD_SIZE") if world_size is None else world_size
    if rank is None or world_size is None:
        raise RuntimeError(
            "no process group to join: start the program with torchrun "
            "--nproc_per_node N (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, "
            "MASTER_PORT), or pass rank, world_size and init_method")
    if local_rank is None:
        local_rank = _env_int("LOCAL_RANK")
        local_rank = rank if local_rank is None else local_rank
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local_rank)
    backend = resolve_backend(device, backend)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size,
                            timeout=timeout)
    return device


def close_distributed() -> None:
    """Leaves the group (after every rank's last collective)."""
    if dist.is_initialized():
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The 'data' axis: ``rank`` of the ``size`` ranks of ``group``, one
    device each; and the 'spatial' axis: ``spatial_rank`` of the
    ``spatial`` ranks of ``spatial_group``.  With the defaults a mesh of
    the 'data' axis alone."""

    group: Any
    size: int
    rank: int
    device: torch.device
    spatial: int = 1
    spatial_rank: int = 0
    spatial_group: Any = None

    def rows(self, batch: int) -> slice:
        """This rank's rows of a global batch of ``batch`` items
        (``batch_rows``)."""
        return batch_rows(batch, self.rank, self.size)

    def barrier(self) -> None:
        if dist.get_backend(self.group) == "nccl":
            dist.barrier(self.group, device_ids=[self.device.index])
        else:
            dist.barrier(self.group)


def batch_rows(batch: int, rank: int, ranks: int) -> slice:
    """Rank ``rank``'s contiguous rows ``[r*B/W, (r+1)*B/W)`` of a global
    batch of ``batch`` items split over ``ranks``; ``B % W != 0`` raises,
    as the JAX sharding does."""
    if batch % ranks or not 0 <= rank < ranks:
        raise ValueError("a global batch of %d does not split over %d "
                         "ranks (rank %d)" % (batch, ranks, rank))
    local = batch // ranks
    return slice(rank * local, (rank + 1) * local)


def make_mesh(data: Optional[int] = None, spatial: int = 1,
              device=None) -> Mesh:
    """The ('data', 'spatial') mesh over the initialised group: ``data``
    defaults to the group's size over ``spatial``, and ``data * spatial``
    must equal the group's size.  With ``spatial > 1`` every rank builds
    the subgroups of both axes (``torch.distributed.new_group``, in one
    order on every rank); with ``spatial=1`` the data axis is the whole
    group.  ``device`` is this rank's: by default the current CUDA device
    (``init_distributed`` sets it to ``cuda:LOCAL_RANK``), whatever the
    group's backend, raising without CUDA; the CPU only where the caller
    passes ``device="cpu"``."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: call "
            "parallel.mesh.init_distributed first (under torchrun, or with "
            "rank, world_size and init_method)")
    world = dist.get_world_size()
    if spatial < 1 or (data is None and world % spatial):
        raise ValueError("spatial=%d does not split the group's %d ranks"
                         % (spatial, world))
    if data is None:
        data = world // spatial
    if data * spatial != world:
        raise ValueError("data=%d x spatial=%d, but the group has %d ranks"
                         % (data, spatial, world))
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if dist.get_backend() == "nccl" and device.type != "cuda":
        raise ValueError("the group runs NCCL, which reduces CUDA tensors "
                         "only; device %s needs a gloo group" % device)
    rank = dist.get_rank()
    if spatial == 1:
        return Mesh(dist.group.WORLD, world, rank, device)
    d, s = divmod(rank, spatial)
    columns = [dist.new_group([dd * spatial + ss for dd in range(data)])
               for ss in range(spatial)]
    rows = [dist.new_group([dd * spatial + ss for ss in range(spatial)])
            for dd in range(data)]
    return Mesh(columns[s], data, d, device, spatial, s, rows[d])


def shard_batch(mesh: Mesh, batch):
    """This rank's slice of a global host batch (a dict of arrays or
    tensors, or one of them) on its device; ``B % W != 0`` raises."""

    def take(x):
        x = host_tensor(x)
        return x[mesh.rows(x.shape[0])].to(mesh.device)

    if isinstance(batch, dict):
        return {k: take(v) for k, v in batch.items()}
    return take(batch)


def replicate(mesh: Mesh, model: torch.nn.Module,
              optimizer: Optional[torch.optim.Optimizer] = None) -> None:
    """Broadcasts the parameters, buffers and optimizer state of rank 0 to
    every rank of the group, both axes of ``mesh``, in place.  The
    optimizer's state must hold the same entries on every rank (both
    empty, or both restored)."""
    tensors = list(model.parameters()) + list(model.buffers())
    if optimizer is not None:
        count = torch.tensor([len(optimizer.state)], device=mesh.device)
        dist.broadcast(count, 0)
        if int(count) != len(optimizer.state):
            raise RuntimeError(
                "optimizer state differs between ranks: %d entries on rank "
                "0, %d on rank %d" % (int(count), len(optimizer.state),
                                      mesh.rank))
        for group in optimizer.param_groups:
            for p in group["params"]:
                tensors += [v for _, v in sorted(
                    optimizer.state.get(p, {}).items())
                    if torch.is_tensor(v)]
    with torch.no_grad():
        for t in tensors:
            if t.device == mesh.device:
                dist.broadcast(t.data, 0)
            else:  # Adam's step counts live on the CPU
                buf = t.detach().to(mesh.device)
                dist.broadcast(buf, 0)
                t.copy_(buf)
