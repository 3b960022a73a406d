"""Bytes and operations of one call of GMFlow's global matching kernel
(softmax(q k^T * scale) v, v two channels wide): q, k and v read once and
the output written once; the operations are the q k^T products alone, two
a multiply-add at bf16, so the exponentials and the two-wide products are
left out and the bound is a floor."""

TARGET = "upflow_pytorch_tpu_torch.ops.kernels.global_match:_global_match"
# the device kernel, by its name in the profile
KERNEL = r"::global_match_kernel\b"


def cost(q, k, v, scale):
    n, length, c = q.shape
    keys = k.shape[1]
    nbytes = (q.numel() * q.element_size() + k.numel() * k.element_size()
              + v.numel() * v.element_size() + n * length * 2 * 4)
    return nbytes, 2 * n * length * keys * c, "bfloat16"
