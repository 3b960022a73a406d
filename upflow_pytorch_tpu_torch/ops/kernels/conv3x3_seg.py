"""Kernel 6: the 3x3 convolution of the bf16 forward (``csrc/conv3x3_seg.cu``).

Replaces ``upflow_pytorch_tpu/ops/pallas/conv.py::_conv3x3_seg_fwd``:

    out = bf16_rn(leaky_0.1(conv3x3_d(x) + bias))

3x3, stride 1, dilation ``d`` with zero padding ``d``; bf16 input and
weights (rounded from the fp32 parameters), exact products summed in fp32,
the fp32 bias and the LeakyReLU (slope 0.1, in fp32) applied to the sum,
one round-to-nearest-even to bf16.  ``relu``: True for that LeakyReLU,
False for none, ``RELU`` for RAFT's ReLU (``models/raft.py``).  Bound by
operations on the H100; the source note in the ``.cu`` file says how the
design meets that.

``x`` and ``out`` may be channel ranges of larger NCHW buffers (each batch
item contiguous, any batch stride): the dense stacks of
``models/blocks.py`` read their input range and write each conv's output
into its slot of one buffer, which is what the TPU kernel's channel
segments were for.

The kernel loads its input by TMA, which needs rows, batch stride and
address in multiples of 16 bytes.  ``staging_route`` decides from the
input's layout alone: "tma" where the input range meets that (the 384 x
1280 pyramid), "pitched" elsewhere (KITTI's 375 x 1242 pyramid, rows of
311 or 156 pixels).  A pitched input is first copied, inside the call,
into a contiguous map whose rows are zero-extended to ``pitched_width``
columns; the kernel tiles that copy by 128 flat pixels and writes only the
caller's columns.  The outputs are those of the TMA route on the
zero-extended map, bit for bit.  ``conv3x3_seg.route_launches`` counts
each route.

The weights go in packed (``pack_weight``).  The model packs them once:
``packed_params`` keeps the packed copy and the fp32 bias on the module
that owns the conv until a parameter changes (``_common.py::cached``), as
after an optimizer step.  A call without ``packed`` packs for itself.

Under autograd ``conv3x3_seg`` goes through ``Conv3x3SegFn``, whose
backward is the JAX package's rule (``conv.py::_bwd``): the LeakyReLU's
gradient from the bf16 output (``out >= 0`` passes it, the rest takes
slope 0.1); ``d_x`` a bf16 convolution of the bf16 cotangent with the
flipped, transposed bf16 weights, summed in fp32 and rounded to bf16;
``d_w`` from the bf16 input's taps and the bf16 cotangent, summed in
fp32; ``d_b`` the fp32 cotangent's sum.  These are library calls
(cuDNN's data gradient, cuBLAS's GEMMs), as the JAX package leaves its
backward to XLA.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from upflow_pytorch_tpu_torch import _build
from upflow_pytorch_tpu_torch.ops.kernels._common import (
    INT, LONG, PTR, cached, check_cpu_input, check_cuda_input,
    count_cuda_call, launch, wants_grad)
from upflow_pytorch_tpu_torch.utils.profiling import span

CHUNK = 64  # input channels per K step of the kernel
BLOCK_WIDTHS = (8, 16, 32, 64, 96, 128)  # the kernel's output tile widths
TMA_ALIGN = 16  # bytes: TMA's rule for the base address and every stride
MAX_DILATION = 16  # the kernel's windows reach 16 pixels left and right

Packed = Tuple[torch.Tensor, torch.Tensor]  # (packed weights, fp32 bias)
RELU = "relu"  # the ``relu`` argument of RAFT's ReLU: negatives to 0


def epilogue(relu) -> int:
    """The kernel's activation code of ``relu``: 0 none, 1 the LeakyReLU
    of slope 0.1, 2 ReLU."""
    return 2 if relu == RELU else int(bool(relu))


def slope(relu) -> float:
    """The activation's slope below zero (``relu`` not False)."""
    return 0.0 if relu == RELU else 0.1


def block_width(cout: int) -> int:
    """Output channels per block of the kernel: the narrowest tile that
    holds all ``cout`` (so each input byte is staged once per pixel tile,
    and the 2- and 3-channel heads pay for 8), or 128 tiles beyond 128."""
    return next((nb for nb in BLOCK_WIDTHS if nb >= cout), BLOCK_WIDTHS[-1])


def swizzle_index(nb: int, device=None) -> torch.Tensor:
    """(nb, 8) int64: the 16-byte group of a 128-byte weight row that holds
    group j of row n, j ^ (n % 8): the 128-byte swizzle that wgmma reads
    and TMA writes.  XOR is its own inverse, so the same index unpacks."""
    n = torch.arange(nb, device=device)[:, None]
    return torch.arange(8, device=device)[None, :] ^ (n % 8)


def pack_weight(weight: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 3, 3) -> the kernel's bf16 layout (Cout/NB, Cin/64, 9,
    NB, 64): per output tile and K step (64-channel chunk, then tap ky*3 +
    kx, the order the kernel runs them) an NB x 64 K-major tile whose
    128-byte rows have their 16-byte groups swizzled (``swizzle_index``).
    Cout and Cin are zero-padded up to whole tiles and chunks."""
    pack_weight.calls += 1
    cout, cin = weight.shape[:2]
    nb = block_width(cout)
    n_blk = -(-cout // nb)
    n_chunk = -(-cin // CHUNK)
    w = F.pad(weight.detach().to(torch.bfloat16),
              (0, 0, 0, 0, 0, n_chunk * CHUNK - cin, 0, n_blk * nb - cout))
    w = w.reshape(n_blk, nb, n_chunk, CHUNK, 9).permute(0, 2, 4, 1, 3)
    w = w.reshape(n_blk, n_chunk, 9, nb, 8, 8)
    rows = torch.arange(nb, device=w.device)[:, None]
    w = w[:, :, :, rows, swizzle_index(nb, w.device)]
    return w.reshape(n_blk, n_chunk, 9, nb, CHUNK).contiguous()


pack_weight.calls = 0


def fp32_bias(weight: torch.Tensor, bias: Optional[torch.Tensor]
              ) -> torch.Tensor:
    """The kernel's fp32 bias: ``bias``, or zeros for a conv without one."""
    if bias is None:
        return torch.zeros(weight.shape[0], dtype=torch.float32,
                           device=weight.device)
    return bias.detach().to(device=weight.device,
                            dtype=torch.float32).contiguous()


def packed_params(owner, weight: torch.Tensor,
                  bias: Optional[torch.Tensor]) -> Packed:
    """The packed weights and the fp32 bias (zeros where ``bias`` is None)
    of the conv that ``owner`` holds, cached on ``owner``
    (``_common.py::cached``)."""
    sources = (weight,) if bias is None else (weight, bias)
    return cached(owner, "_conv3x3_seg_packed", sources, lambda: (
        pack_weight(weight), fp32_bias(weight, bias)))


def staging_route(w: int, batch_stride: int, data_ptr: int) -> str:
    """How the kernel stages a bf16 input range of width ``w``: "tma" when
    its rows (and so its planes), its batch stride (elements) and its
    address are multiples of 16 bytes, as TMA's tensor map needs;
    "pitched" (a zero-extended copy, ``pitched_width``) otherwise."""
    ok = (2 * w % TMA_ALIGN == 0 and 2 * batch_stride % TMA_ALIGN == 0
          and data_ptr % TMA_ALIGN == 0)
    return "tma" if ok else "pitched"


def pitched_width(w: int, dilation: int) -> int:
    """The row pitch of a pitched input's copy: the least multiple of 8
    (16 bytes) that is at least ``w + dilation``, so that a column tap past
    either end of a row reads zeros of the copy's columns [w, pitch)."""
    return -(-(w + dilation) // 8) * 8


def conv3x3_seg_plain(x: torch.Tensor, weight: torch.Tensor,
                      bias: Optional[torch.Tensor], dilation: int, relu: bool,
                      out: Optional[torch.Tensor] = None,
                      packed: Optional[Packed] = None) -> torch.Tensor:
    """Plain PyTorch version: the bf16 input and the bf16-rounded weights
    widened to fp32, an fp32 convolution (TF32 off), the fp32 bias, the
    LeakyReLU in fp32, one rounding to bf16 (no bias where ``bias`` is
    None).  Writes into ``out`` when it is given and returns it;
    ``packed`` is not read."""
    count_cuda_call(conv3x3_seg_plain, x, weight)
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        acc = F.conv2d(x.float(), weight.to(torch.bfloat16).float(), None,
                       padding=dilation, dilation=dilation)
    if bias is not None:
        acc = acc + bias.float()[None, :, None, None]
    if relu:
        acc = torch.where(acc >= 0, acc, acc * slope(relu))
    y = acc.to(torch.bfloat16)
    if out is None:
        return y
    return out.copy_(y)


conv3x3_seg_plain.cuda_calls = 0


def conv3x3_seg_cuda(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor], dilation: int, relu: bool,
                     out: Optional[torch.Tensor] = None,
                     packed: Optional[Packed] = None) -> torch.Tensor:
    """Launches ``upflow_conv3x3_seg`` on the current stream."""
    op = "conv3x3_seg"
    check_cuda_input(op, "x", x, (None, None, None, None),
                     dtypes=(torch.bfloat16,), batch_strided=True)
    b, cin, h, w = x.shape
    cout = weight.shape[0]
    if tuple(weight.shape) != (cout, cin, 3, 3) or cout == 0 or cin == 0:
        raise ValueError("%s: weight has shape %s, expected (Cout, %d, 3, 3)"
                         % (op, tuple(weight.shape), cin))
    if bias is not None and tuple(bias.shape) != (cout,):
        raise ValueError("%s: bias has shape %s, expected (%d,)"
                         % (op, tuple(bias.shape), cout))
    if not 1 <= dilation <= MAX_DILATION:
        raise ValueError("%s: dilation %d outside 1..%d"
                         % (op, dilation, MAX_DILATION))
    if out is None:
        out = torch.empty((b, cout, h, w), dtype=torch.bfloat16,
                          device=x.device)
    check_cuda_input(op, "out", out, (b, cout, h, w), x.device,
                     (torch.bfloat16,), batch_strided=True)
    if packed is None:
        weight = weight.to(x.device)
        packed = (pack_weight(weight), fp32_bias(weight, bias))
    wp, bias32 = packed
    nb = block_width(cout)
    if (wp.device != x.device or wp.dtype != torch.bfloat16
            or tuple(wp.shape) != (-(-cout // nb), -(-cin // CHUNK), 9, nb,
                                   CHUNK)
            or bias32.device != x.device or bias32.dtype != torch.float32):
        raise ValueError("%s: packed weights do not fit a (%d, %d, 3, 3) "
                         "conv on %s" % (op, cout, cin, x.device))
    route = staging_route(w, x.stride(0), x.data_ptr())
    xs, pitch = x, w
    if route == "pitched":
        pitch = pitched_width(w, dilation)
        xs = x.new_empty((b, cin, h, pitch))
        xs[..., w:].zero_()
        xs[..., :w].copy_(x)
    vec_out = (w * 2 % 16 == 0 and out.stride(0) * 2 % 16 == 0
               and out.data_ptr() % 16 == 0)
    fn = _build.kernel_fn("upflow_conv3x3_seg",
                          [PTR, LONG, PTR, PTR, PTR, LONG, INT, INT, INT,
                           INT, INT, INT, INT, INT, INT, INT, PTR])
    conv3x3_seg.route_launches[route] += 1
    launch(op, conv3x3_seg, x, fn, xs.data_ptr(), xs.stride(0),
           wp.data_ptr(), bias32.data_ptr(), out.data_ptr(), out.stride(0),
           b, cin, cout, h, w, pitch, int(dilation), epilogue(relu), nb,
           int(vec_out))
    return out


def _conv3x3_seg(x, weight, bias, dilation, relu, out, packed):
    if x.is_cuda:
        return conv3x3_seg_cuda(x, weight, bias, dilation, relu, out, packed)
    check_cpu_input("conv3x3_seg", x)
    return conv3x3_seg_plain(x, weight, bias, dilation, relu, out)


def conv3x3_seg_vjp(x: torch.Tensor, weight: torch.Tensor,
                    out: Optional[torch.Tensor], dilation: int,
                    g: torch.Tensor, needs=(True, True, True),
                    relu=True):
    """(d_x, d_weight, d_bias) of ``conv3x3_seg`` given its bf16 output
    ``out`` (None without the activation, ``relu`` the activation) and the
    output's cotangent ``g``; an entry whose ``needs`` is False is None.

    ``d_x`` is a bf16 convolution with fp32 sums: cuDNN's on the card; on
    the CPU, whose bf16 convolution differs from one with fp32 sums, an
    fp32 convolution of the widened operands (their products are exact),
    rounded once.  ``d_weight`` is, as in the JAX rule, a product of the
    bf16 input's taps and the bf16 cotangent with fp32 sums: one GEMM per
    batch item over the unfolded input (on the card ``torch.bmm`` with an
    fp32 output, as cuDNN's fp32 weight gradient picks an algorithm 15-30
    ms slow at two of the step's shapes), summed over the batch in fp32.
    """
    g = g.float()
    if out is not None:
        g = torch.where(out >= 0, g, g * slope(relu))
    gb = g.to(torch.bfloat16)
    d_x = d_w = d_b = None
    if needs[0]:
        wb = weight.to(torch.bfloat16)
        if x.is_cuda:
            d_x = torch.nn.grad.conv2d_input(
                x.shape, wb, gb, padding=dilation, dilation=dilation)
        else:
            cudnn = torch.backends.cudnn
            with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                             deterministic=cudnn.deterministic,
                             allow_tf32=False):
                d_x = torch.nn.grad.conv2d_input(
                    x.shape, wb.float(), gb.float(), padding=dilation,
                    dilation=dilation).to(torch.bfloat16)
    if needs[1]:
        b, _, h, w = x.shape
        if x.is_cuda:
            cols = F.unfold(x, 3, dilation=dilation, padding=dilation)
            taps = torch.bmm(gb.reshape(b, -1, h * w), cols.transpose(1, 2),
                             out_dtype=torch.float32)
        else:
            cols = F.unfold(x.float(), 3, dilation=dilation,
                            padding=dilation)
            taps = torch.bmm(gb.float().reshape(b, -1, h * w),
                             cols.transpose(1, 2))
        d_w = taps.sum(dim=0).reshape(weight.shape).to(weight.dtype)
    if needs[2]:
        d_b = g.sum(dim=(0, 2, 3))
    return d_x, d_w, d_b


class Conv3x3SegFn(torch.autograd.Function):
    """``conv3x3_seg`` (without ``out``) with the JAX package's gradient
    rule."""

    @staticmethod
    def forward(ctx, x, weight, bias, dilation, relu, packed):
        out = _conv3x3_seg(x, weight, bias, dilation, relu, None, packed)
        ctx.save_for_backward(x, weight, out if relu else None)
        ctx.dilation, ctx.relu = dilation, relu
        return out

    @staticmethod
    def backward(ctx, g):
        with span("upflow.rule.Conv3x3SegFn"):
            x, weight, out = ctx.saved_tensors
            return conv3x3_seg_vjp(x, weight, out, ctx.dilation, g,
                                   ctx.needs_input_grad[:3],
                                   ctx.relu) + (None,) * 3


def conv3x3_seg(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor],
                dilation: int = 1, relu: bool = True,
                out: Optional[torch.Tensor] = None,
                packed: Optional[Packed] = None) -> torch.Tensor:
    """bf16 3x3 conv + bias (+ LeakyReLU, or ReLU with ``relu=RELU``):
    the kernel for CUDA tensors, the plain version for CPU tensors;
    through ``Conv3x3SegFn`` under autograd, where ``out`` must be None.
    ``x``: (B, Cin, H, W) bf16; ``weight``: (Cout, Cin, 3, 3); ``bias``:
    (Cout,) or None for a conv without one; ``out``: an optional (B, Cout,
    H, W) bf16 destination, such as a channel slot of a dense buffer;
    ``packed``: the weights as ``packed_params`` gives them, packed here
    when it is None."""
    if wants_grad(x, weight, bias):
        if out is not None:
            raise ValueError("conv3x3_seg: under autograd the output is a "
                             "new tensor; out must be None")
        return Conv3x3SegFn.apply(x, weight, bias, dilation, relu, packed)
    return _conv3x3_seg(x, weight, bias, dilation, relu, out, packed)


conv3x3_seg.launches = 0
conv3x3_seg.route_launches = {"tma": 0, "pitched": 0}
