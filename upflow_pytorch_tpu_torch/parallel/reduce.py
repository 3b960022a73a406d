"""The reductions over the ranks that make N ranks at B/N compute what one
process computes at B.

The JAX package's sharded step is one GSPMD program over the global batch,
so every sum of its loss is global.  The port's ranks each run the loss on
their slice; three kinds of term need care:

- a plain ``.mean()`` over the batch (smoothness, the unmasked
  photometric and census terms): the shards are equal, so the rank
  average of the local means is the global mean, and nothing changes;
- a masked ratio ``sum(x * m) / (sum(m) + eps)`` (the occlusion-masked
  photometric and distillation terms, the masked census term, the
  equivariance loss): the denominator is summed over the ranks
  (``global_sum``) and the numerator scaled by the number of ranks
  (``rank_share``), so that the rank average of the local terms, and of
  their gradients, is the global ratio and its gradient;
- an unnormalised ``sum``: scaled by the number of ranks.

The helpers act only inside ``global_normalisers(mesh)`` with a mesh of
more than one rank; elsewhere they return their argument, so a single
process computes exactly what it computed before.  The denominators are
masks built by comparisons (the occlusion check runs without autograd, the
equivariance masks are thresholds), so they carry no gradient, and
``global_sum`` refuses one that does.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Iterable, Iterator

import torch
import torch.distributed as dist

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "upflow_global_normalisers", default=None)


@contextlib.contextmanager
def global_normalisers(mesh) -> Iterator[None]:
    """The loss computed inside the block takes its normalisers over every
    rank of ``mesh`` (``parallel/mesh.py::Mesh``)."""
    token = _ACTIVE.set(mesh if mesh.size > 1 else None)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x``, a sum over this rank's items, summed over the ranks."""
    mesh = _ACTIVE.get()
    if mesh is None:
        return x
    if x.requires_grad:
        raise ValueError("a loss normaliser carries a gradient; summing it "
                         "over the ranks would drop the other ranks' part")
    total = x.detach().clone()
    dist.all_reduce(total, group=mesh.group)
    return total


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """``x``, a mean over this rank's items, averaged over the ranks: the
    mean over the global batch, as every rank holds as many items."""
    mesh = _ACTIVE.get()
    if mesh is None:
        return x
    return global_sum(x) / mesh.size


def rank_share(x: torch.Tensor) -> torch.Tensor:
    """``x``, a sum over this rank's items, times the number of ranks: the
    rank average of the result is the global sum."""
    mesh = _ACTIVE.get()
    if mesh is None:
        return x
    return x * mesh.size


def average_gradients(mesh, params: Iterable[torch.nn.Parameter]) -> None:
    """Replaces each parameter's gradient by its average over the ranks,
    in one flat all-reduce; parameters without a gradient (frozen, or not
    reached) are left out, as they are on every rank."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    flat /= mesh.size
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def average_metrics(mesh, metrics: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """The 0-dim metrics averaged over the ranks in one all-reduce: every
    rank reports the global value, the same bits on each."""
    names = list(metrics)
    flat = torch.stack([metrics[n].detach().float() for n in names])
    dist.all_reduce(flat, group=mesh.group)
    flat /= mesh.size
    return {n: flat[i] for i, n in enumerate(names)}
