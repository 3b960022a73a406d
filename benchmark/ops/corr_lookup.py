"""Bytes and operations of one call of RAFT's correlation lookup: each
pixel's coordinates read, its 10 x 10 footprint read from each of the 4
fp32 levels (as much of it as a level holds: the coarsest, 5 x 19 at
KITTI's grid, has 5 rows), its 324 outputs written; per tap the bilinear
weights' products and sums (7)."""

TARGET = "upflow_pytorch_tpu_torch.ops.kernels.corr_lookup:_corr_lookup"
# the device kernel, by its name in the profile
KERNEL = r"::corr_lookup_kernel\b"

FOOTPRINT, TAPS = 10, 81


def cost(levels, coords, dtype):
    n, _, h, w = coords.shape
    px = n * h * w
    out_bytes = 2 if "bfloat16" in str(dtype) else 4
    read = sum(min(FOOTPRINT, v.shape[-2]) * min(FOOTPRINT, v.shape[-1]) * 4
               for v in levels)
    return (px * (2 * 4 + read + len(levels) * TAPS * out_bytes),
            px * len(levels) * TAPS * 7, "float32")
