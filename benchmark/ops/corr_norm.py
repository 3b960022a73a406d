"""Bytes and operations of one call of the normalised correlation (kernel
3): both maps and the (B, 4, C) affine read once, the fp32 cost volume
written once; per output pixel and tap a product and a sum per channel,
the affine of both maps per channel, and the mean and LeakyReLU per tap."""

TARGET = "upflow_pytorch_tpu_torch.ops.kernels.corr_norm:_corr_norm"
# the device kernel, by its name in the profile
KERNEL = r"::corr_norm_kernel\b"

TAPS = 81  # search range 4


def cost(f1, f2, aff, leaky_slope, width=None):
    b, c, h, w = f1.shape
    px = b * h * w
    return (f1.element_size() * 2 * px * c + 4 * (b * 4 * c + TAPS * px),
            px * (2 * TAPS * c + 4 * c + 2 * TAPS), "float32")
