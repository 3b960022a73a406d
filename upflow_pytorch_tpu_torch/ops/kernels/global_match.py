"""GMFlow's global softmax matching and flow propagation
(``csrc/global_match.cu``) and their plain version.

``global_match(q, k, v, scale)`` is softmax(q k^T * scale) v over every
key of a frame, for a ``v`` two channels wide:

- matching (``matching.py::global_correlation_softmax``): q the first
  frame's features, k the second's, v the key pixels' (x, y); the flow
  is the output less the query pixel's (x, y).  Both directions are one
  call: the backward direction's softmax over the transposed correlation
  is the second frame's features against the first's;
- propagation (``gmflow.py::FeatureFlowAttention``, global): q and k
  the projected features of one frame, v its flow.

The kernel never stores the L x S matrix (7,488 x 7,488 at KITTI's 48 x
156 grid, 224 MB in fp32 a direction), which the published code builds,
concatenates with its transpose and normalises.  No library attention
takes a V two channels wide without padding it to the width of Q, which
would double the work.

The plain version runs the published matmul, softmax and matmul in fp32
on blocks of queries (``PLAIN_BLOCK`` rows at a time), so that it holds a
block's rows and never the whole matrix.  The wrapper takes it only for
CPU tensors; a CUDA tensor launches the kernel, which takes bf16 q and k
with 128 channels, or raises.  There is no gradient rule: GMFlow's
training is not ported.
"""

from __future__ import annotations

import math

import torch

from upflow_pytorch_tpu_torch import _build
from upflow_pytorch_tpu_torch.ops.kernels._common import (
    FLOAT, INT, PTR, check_cpu_input, check_cuda_input, count_cuda_call,
    launch, wants_grad)

CHANNELS = 128  # the kernel's q and k width: GMFlow's feature_channels
PLAIN_BLOCK = 1024  # query rows a step of the plain version


def global_match_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float) -> torch.Tensor:
    """Plain PyTorch version: for each block of queries, the fp32 scores
    ``q k^T * scale``, their softmax over the keys and its product with
    ``v``; (N, L, 2) fp32."""
    count_cuda_call(global_match_plain, q, k)
    n, length, _ = q.shape
    kt = k.float().transpose(1, 2)
    vf = v.float()
    out = torch.empty((n, length, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    for s in range(0, length, PLAIN_BLOCK):
        scores = torch.matmul(q[:, s:s + PLAIN_BLOCK].float(), kt) * scale
        out[:, s:s + PLAIN_BLOCK] = torch.matmul(
            torch.softmax(scores, dim=-1), vf)
    return out


global_match_plain.cuda_calls = 0


def global_match_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: float) -> torch.Tensor:
    """Launches ``upflow_global_match`` on the current stream: one launch
    for the N items (both directions of B pairs are N = 2B)."""
    op = "global_match"
    check_cuda_input(op, "q", q, (None, None, CHANNELS),
                     dtypes=(torch.bfloat16,))
    n, length, _ = q.shape
    check_cuda_input(op, "k", k, (n, None, CHANNELS), q.device,
                     (torch.bfloat16,))
    keys = k.shape[1]
    check_cuda_input(op, "v", v, (n, keys, 2), q.device)
    if keys == 0:
        raise ValueError("%s: a softmax over no keys" % op)
    out = torch.empty((n, length, 2), dtype=torch.float32, device=q.device)
    fn = _build.kernel_fn("upflow_global_match",
                          [PTR, PTR, PTR, PTR, INT, INT, INT, FLOAT, PTR])
    launch(op, global_match, q, fn, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), out.data_ptr(), n, length, keys,
           float(scale * math.log2(math.e)))
    return out


def _global_match(q, k, v, scale):
    if q.is_cuda:
        return global_match_cuda(q, k, v, scale)
    check_cpu_input("global_match", q)
    return global_match_plain(q, k, v, scale)


def global_match(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v: ``q`` (N, L, C) and ``k`` (N, S, C) (bf16
    with C = 128 on the card), ``v`` (N, S, 2) fp32; (N, L, 2) fp32.  The
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if wants_grad(q, k, v):
        raise NotImplementedError("global_match has no gradient rule: "
                                  "GMFlow's training is not ported")
    return _global_match(q, k, v, scale)


global_match.launches = 0
