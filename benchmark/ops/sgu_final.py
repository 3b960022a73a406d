"""Bytes and operations of one call of the final SGU stage (kernel 8): the
quarter-resolution flow and head read once, the full-resolution flow
written once, fp32; per output pixel three resized samples and their
scales (29), the taps (30), and per flow plane five resized samples, five
scales, the tap sum and the blend (61)."""

TARGET = "upflow_pytorch_tpu_torch.ops.kernels.sgu_final:_sgu_final"
# the device kernel, by its name in the profile
KERNEL = r"::sgu_final_kernel\b"


def cost(flow_q, x_out, out_hw, x0=0, w_out=None):
    b, _, hq, wq = flow_q.shape
    px = b * int(out_hw[0]) * (int(out_hw[1]) if w_out is None else w_out)
    return 4 * (5 * b * hq * wq + 2 * px), px * (29 + 30 + 2 * 61), \
        "float32"
