"""Bytes and operations of one call of the plain correlation (kernel 1):
both maps read once, the fp32 cost volume written once; per output pixel
and tap a product and a sum per channel, and the channel mean."""

TARGET = "upflow_pytorch_tpu_torch.ops.kernels.correlation:_correlation"
# the device kernel, by its name in the profile
KERNEL = r"::corr_plain_kernel\b"


def cost(f1, f2, max_displacement, width=None):
    b, c, h, w = f1.shape
    taps = (2 * int(max_displacement) + 1) ** 2
    px = b * h * w
    return (f1.element_size() * 2 * px * c + 4 * taps * px,
            px * (2 * taps * c + taps), "float32")
