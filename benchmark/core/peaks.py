"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): HBM3 bandwidth, and operations per
second by the arithmetic's type (fp32 outside the tensor cores, TF32 and
bf16 on them)."""

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}


def bound_s(nbytes: float, flops: float, kind: str) -> float:
    """The least time the chip could take: the larger of the bytes over
    the bandwidth and the operations over their type's peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FLOPS_PER_S[kind])
