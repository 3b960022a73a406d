"""Bytes and operations of one call of the bf16 3x3 conv (kernel 6): the
bf16 input, weights and output once and the fp32 bias; two operations per
multiply-add, on the bf16 tensor cores."""

TARGET = "upflow_pytorch_tpu_torch.ops.kernels.conv3x3_seg:_conv3x3_seg"
# the device kernel, by its name in the profile
KERNEL = r"::conv3x3_seg_kernel\b"


def cost(x, weight, bias, dilation, relu, out, packed):
    b, cin, h, w = x.shape
    cout = weight.shape[0]
    px = b * h * w
    return (2 * px * (cin + cout) + 2 * 9 * cin * cout + 4 * cout,
            2 * 9 * px * cin * cout, "bfloat16")
