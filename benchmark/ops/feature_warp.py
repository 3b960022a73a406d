"""Bytes and operations of one call of the masked feature warp (kernel 2):
the map and the fp32 flow read once, the warped map (and the fp32 mask,
when asked for) written once; per output pixel the coordinates, weights
and mask test (30), and per channel four taps' products and sums (8)."""

TARGET = "upflow_pytorch_tpu_torch.ops.kernels.feature_warp:_feature_warp"
# the device kernel, by its name in the profile
KERNEL = r"::feature_warp_kernel\b"


def cost(x, flow, thr, with_mask, x0=0):
    b, c, h, w = x.shape
    px = b * h * flow.shape[3]
    nbytes = x.element_size() * c * (b * h * w + px) + 4 * 2 * px
    if with_mask:
        nbytes += 4 * px
    return nbytes, px * (30 + 8 * c), "float32"
