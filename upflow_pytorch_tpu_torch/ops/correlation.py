"""Local cost-volume correlation, NCHW.

The reference's correlation op (``pad_size=4, kernel_size=1,
max_displacement=4``):

    out[b, k, y, x] = (1/C) * sum_c f1[b, c, y, x] * f2[b, c, y+dy, x+dx]

with ``k = (dy+D)*(2D+1) + (dx+D)`` and zero padding outside ``f2``: the
channel MEAN, with the LeakyReLU applied by the caller.  ``correlation``
launches the CUDA kernel (``ops/kernels/correlation.py``) for CUDA tensors
and runs ``correlation_plain`` for CPU tensors.
"""

from upflow_pytorch_tpu_torch.ops.kernels.correlation import (  # noqa: F401
    correlation,
    correlation_plain,
)
