"""Bytes and operations of one call of the image warp (kernel 4, the
occlusion check's flow warp): source and flow read once, the output
written once, fp32; per output pixel the coordinates and weights (30), and
per channel four taps' products and sums less one (7)."""

TARGET = "upflow_pytorch_tpu_torch.ops.kernels.warp:_warp"
# the device kernel, by its name in the profile
KERNEL = r"::warp_kernel\b"


def cost(x, flow, x0=0):
    b, c, ih, iw = x.shape
    px = b * flow.shape[2] * flow.shape[3]
    return 4 * (c * b * ih * iw + 2 * px + c * px), px * (30 + 7 * c), \
        "float32"
