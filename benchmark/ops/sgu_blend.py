"""Bytes and operations of one call of the SGU blend of both directions
(kernel 7): per pixel and direction the fp32 flow and the raw head read,
the fp32 output written; the taps (30), the sigmoid besides its exp (3),
and per flow plane the tap sum (7) and the blend (4)."""

TARGET = "upflow_pytorch_tpu_torch.ops.kernels.sgu_blend:_sgu_blend_pair"
# the device kernel, by its name in the profile
KERNEL = r"::sgu_blend_kernel\b"


def cost(flow_1, x_out_1, flow_2, x_out_2, x0=0):
    b, _, h, w = x_out_1.shape
    px = 2 * b * h * w
    return (px * (8 + 3 * x_out_1.element_size() + 8),
            px * (30 + 3 + 2 * 11), "float32")
